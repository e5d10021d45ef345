"""The yardstick for the port's hand kernels: their CUDA function names as
the profiler shows them, the card's published peaks, and the work each
launch needs, from its shapes.

Peaks: one NVIDIA H100 SXM at 700 W, dense rates (NVIDIA's data sheet):
989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM.  A roofline share
is the least time the card could take (the larger of operations over the
peak rate and bytes over the memory rate) over the kernel's device time.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}

#: kernel -> CUDA function name (a substring of the profiler's event name)
FUNCTION = {
    1: "fused_select_kernel",
    3: "gather_score_kernel",
    4: "traverse_kernel",
    5: "rescore_kernel",  # rescore_kernel_{warp,block,split}
}


def kernel_seconds(record: dict, kernel: int) -> tuple[float, int]:
    """Device seconds and events of `kernel` in a trace record."""
    t = n = 0
    for name, (s, c) in record["device_ops"].items():
        if FUNCTION[kernel] in name:
            t += s
            n += c
    return t, n


def ms_per_request(record: dict, kernel: int) -> float | None:
    t, n = kernel_seconds(record, kernel)
    return 1e3 * t / record["requests"] if n and record["requests"] else None


def fused_select_bound_s(b: int, m: int, d: int, instance: str) -> float:
    """Kernel 1's least time for one launch: 2·B·M·d operations at the
    instance's peak, or its inputs' bytes (queries, rows, the per-query
    scale and per-item multiplier and offset) at the memory rate, on the
    unpadded shapes, the work the inputs need."""
    es = 1 if instance == "int8" else 2
    ops = 2.0 * b * m * d
    nbytes = (b + m) * d * es + 4 * (b + 2 * m)
    return max(ops / PEAK_OPS[instance], nbytes / HBM_BPS)
