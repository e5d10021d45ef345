"""Kernel 1's share of its roofline, per cent (`ops/fused_select` ->
`csrc/fused_select.cu`): the least time its launches in the traced
segment could take (`kernels.fused_select_bound_s` at each launched
instance's peak, counted by the port's launch counters) over their
device time."""

from benchmark.kernels import fused_select_bound_s, kernel_seconds


def read(r):
    t, n = kernel_seconds(r, 1)
    launched = {i: r["launches"].get(f"fused_select_{i}", 0) for i in ("int8", "bf16")}
    if not n or t <= 0 or sum(launched.values()) != n:
        return None
    bound = sum(c * fused_select_bound_s(r["batch"], r["n_items"], r["dims"], i)
                for i, c in launched.items())
    return 100.0 * bound / t
