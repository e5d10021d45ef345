"""Device events (kernels, copies, sets) a request launches, counted in
the traced segment: the engine's host dispatch, one launch at a time."""


def read(r):
    return r["n_device_events"] / r["requests"] if r["requests"] and r["n_device_events"] else None
