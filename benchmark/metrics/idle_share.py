"""Per cent of a request's wall time in which the card is idle:
1 - (device busy per request, traced) / (wall per request of the measured
window, without the profiler), the method of `scripts/torch_profile.py`."""


def read(r):
    if not r["requests"] or not r["loop_requests"] or r["busy_s"] <= 0:
        return None
    busy = r["busy_s"] / r["requests"]
    wall = r["loop_seconds"] / r["loop_requests"]
    return 100.0 * (1.0 - busy / wall)
