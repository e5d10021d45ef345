"""Device milliseconds a request keeps the card busy: the union of the
intervals of every device event (kernels, copies, sets) in the traced
segment, per request."""


def read(r):
    return 1e3 * r["busy_s"] / r["requests"] if r["requests"] and r["busy_s"] > 0 else None
