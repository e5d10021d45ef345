"""Device milliseconds a request spends in kernel 4, the traversal's pop
loop (`ops/traverse` -> `csrc/traverse.cu`)."""

from benchmark.kernels import ms_per_request


def read(r):
    return ms_per_request(r, 4)
