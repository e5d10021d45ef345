"""The traced segment of a ``--trace 1`` run, read from `torch.profiler`.

After the measured window, the same loop runs for `SECONDS` more under
the profiler (CPU and CUDA activity), with a `record_function` span
around each step of a request.  The record handed to the per-layer
readers holds the device's events (kernels, copies, sets) by name, their
busy time (the union of their intervals), the program's launch counters
over the segment, and the unprofiled window's figures beside them.

Device busy follows `scripts/torch_profile.py`'s method on one stream;
the union of intervals is taken so that no overlap counts twice.
"""

from __future__ import annotations

import bisect

import torch
from torch.autograd import DeviceType

#: seconds the profiler records after the measured window
SECONDS = 2.0
#: entries of each list in the result's "breakdown"
TOP = 10


def launch_counters() -> dict:
    """The port's own launch counters, flattened (names of the program)."""
    from arroy_tpu_torch import search
    from arroy_tpu_torch.ops import bq_kernels, fused_select, gather_score, rescore, traverse

    out = {}
    for mod in (fused_select, bq_kernels, gather_score, traverse, rescore):
        out.update(mod.launches)
    out.update({f"scan.{k}": v for k, v in search.scan_calls.items()})
    return out


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _events(prof):
    """(device [(name, start_us, end_us)], host [(name, start_us, end_us)] of
    the thread that ran the loop)."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("bench."):  # the spans' own device-side annotations
                dev.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, tr.start, tr.end, e.thread))
    loop_threads = {t for n, _, _, t in host if n.startswith("bench.")}
    host = [(n, s, e) for n, s, e, t in host if t in loop_threads and e > s]
    return dev, host


def _host_at(ops, starts, spans, t):
    """What the host was doing at time t: the innermost op running then
    (the latest start among the recent ops that cover t), else the
    benchmark's span around it (`spans`: the spans sorted by start, and
    their starts; they do not nest), else None."""
    j = bisect.bisect_right(starts, t)
    best = None
    for n, s, e in ops[max(0, j - 64):j]:
        if e >= t and (best is None or s > best[1]):
            best = (n, s)
    if best:
        return best[0]
    j = bisect.bisect_right(spans[1], t) - 1
    if j >= 0 and spans[0][j][2] >= t:
        return spans[0][j][0]
    return None


def summarize(dev, host, wall_s: float) -> dict:
    """The trace's figures: busy seconds, events, time by device op, and the
    idle gaps between device work by what the host was doing."""
    merged = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_op: dict = {}
    for name, s, e in dev:
        t, c = by_op.get(name, (0.0, 0))
        by_op[name] = (t + (e - s) * 1e-6, c + 1)
    ops = sorted((h for h in host if not h[0].startswith("bench.")), key=lambda h: h[1])
    spans = sorted((h for h in host if h[0].startswith("bench.")), key=lambda h: h[1])
    spans = (spans, [h[1] for h in spans])
    starts = [h[1] for h in ops]
    gaps: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        name = _host_at(ops, starts, spans, 0.5 * (e0 + s1)) or "host (no recorded op)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": wall_s,
        "n_device_events": len(dev),
        "device_ops": by_op,
        "breakdown": {
            "device_ops": [[n, t] for n, (t, _) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:TOP]],
            "idle_gaps": [[n, t] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def traced_segment(drive, device, seconds: float = SECONDS):
    """Run `drive(seconds, spans=True)` under the profiler; returns (window,
    trace summary, launch counter deltas)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    c0 = launch_counters()
    with torch.profiler.profile(activities=acts) as prof:
        w = drive(seconds, spans=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    c1 = launch_counters()
    dev, host = _events(prof)
    summary = summarize(dev, host, w.seconds)
    summary["launches"] = {k: c1[k] - c0[k] for k in c1}
    return w, summary
