"""Device-side profiling hooks.

Counterpart of `arroy_tpu/utils/profiling.py`.  The reference traces
build milestones with the `tracing` crate (reference:
src/writer.rs:515,609,...); for kernel time the port uses
`torch.profiler`.  `trace(dir)` wraps any region (build, query loop) and
writes a Chrome trace of it into ``dir``.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region; yields the profiler.

    Host operators are always recorded, and CUDA kernels too when a card
    is present (its kernels, the hand-written ones included, appear by
    name).  On exit the card is synchronised, so every kernel the region
    queued is in the trace, and ``log_dir`` receives a
    ``*.pt.trace.json`` file that chrome://tracing, Perfetto and
    TensorBoard read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Host wall-clock timing of a region (the `Instant` role)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {time.perf_counter() - t0:.3f}s")
