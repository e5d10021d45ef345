"""Device milliseconds a request spends in kernel 3, the probe's
gather-score (`ops/gather_score` -> `csrc/gather_score.cu`)."""

from benchmark.kernels import ms_per_request


def read(r):
    return ms_per_request(r, 3)
