"""Device milliseconds a request spends in kernel 5, the exact re-score
and top-k (`ops/rescore` -> `csrc/rescore.cu`)."""

from benchmark.kernels import ms_per_request


def read(r):
    return ms_per_request(r, 5)
