"""Device milliseconds a request spends in kernel 6, the probe's stage 1
(`ops/rank_select` -> `csrc/rank_select.cu`: its scan and its merge,
`rank_select_kernel_{scan,merge}`).  None where no such kernel ran."""

#: a substring of both of kernel 6's CUDA function names
FUNCTION = "rank_select_kernel"


def read(r):
    t = n = 0
    for name, (s, c) in r["device_ops"].items():
        if FUNCTION in name:
            t += s
            n += c
    return 1e3 * t / r["requests"] if n and r["requests"] else None
