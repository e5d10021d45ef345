#!/usr/bin/env python3
"""The program's stages in one benchmark cell, read from its own spans.

Builds the cell as ``benchmark/run.py`` does (configuration, traffic and
inputs from ``--seed``, `Writer.add_items`, the build and
`Reader.searcher`, then warm-up requests) inside
`utils.profiling.recording()`, so each set-up phase has its host wall.
Then, on the cell's request schedule:

1. an untraced window of ``--seconds`` (the benchmark's closed loop):
   host ms a request;
2. ``--requests`` requests under `torch.profiler` (host and CUDA
   activity, the profile the benchmark's traced segment takes): for each
   ``arroy.*`` span name, per request, its host wall, its host self time
   (wall less the spans inside it), the host time it spends inside
   synchronising CUDA runtime calls (``dispatch`` is the wall less this),
   and its device time: the union of the device events (kernels, copies,
   sets) whose launch call lies inside it.  Each idle gap between device
   work goes to the innermost span covering its middle;
3. the same requests again under `utils.profiling.counting()`, with no
   profiler: each hand kernel's work records, and the roofline share of
   kernels 3, 4, 5 and 6, their least time (below) over their device time
   in step 2.

Least times, at the HBM rate of `benchmark.kernels` (3.35 TB/s) and, for
kernel 6, the f32 FFMA peak (`F32_PEAK`), whichever is larger:
kernel 3 reads the distinct blocks (with its epilogue, each row's aux
and slot, an int8 scale and a filter byte beside them), `bid`, the
queries and writes the [B, C, P] f32 scores; kernel 4 takes the larger of its longest query's
pops times one dependent L2 read (`L2_READ_S`) and the node rows and
margins its pops touch; kernel 5 reads the distinct valid rows (row,
norm, id), the keys and positions (cut) or the candidate list and mask,
the queries, and writes the [B, k] ids and distances; kernel 6 (the
probe's stage 1, calls that took it) does 2·B·T·nb_max·d operations, or
reads the centroids, caux, the mask and the queries and writes the
[B, T·L] ids.

Prints one JSON object (and writes it to ``--out`` if given).  Run
from the repository root on a machine with a card:

    python3 scripts/torch_stages.py --workload <cell> --seed <n> [--seconds 10] [--requests 40]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import cell as cell_mod, data, kernels, loop, run, spec  # noqa: E402

#: the lowest time one dependent L2 read took on an NVIDIA H100 80GB HBM3
#: (`ops.traverse.l2_chase`, PERF.md section 6): the floor of a pop
L2_READ_S = 144e-9
#: bytes a pop of kernel 4 reads: one node row (8 int32) and one margin
POP_BYTES = 8 * 4 + 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: one NVIDIA H100 SXM's f32 rate outside the tensor cores (data sheet, 700 W)
F32_PEAK = 67e12
#: kernel -> CUDA function name: the benchmark's, and kernel 6's scan and merge
FUNCTION = {**kernels.FUNCTION, 6: "rank_select_kernel"}
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def least_seconds(w: dict) -> float:
    """The least time of one call with work record `w`."""
    if w["kernel"] == "gather_score":
        b, c, p, d = w["B"], w["C"], w["P"], w["d"]
        per_block = p * d * w["elem_bytes"]
        ep = w.get("epilogue")
        if ep:  # aux and slots, a scale, a filter byte a row
            per_block += p * (8 + 4 * ep["scale"] + ep["filtered"])
        nbytes = w["blocks"] * per_block + 4 * b * c + 4 * b * d + 4 * b * c * p
        return nbytes / kernels.HBM_BPS
    if w["kernel"] == "traverse":
        return max(w["pops_max"] * L2_READ_S, w["pops_total"] * POP_BYTES / kernels.HBM_BPS)
    if w["kernel"] == "rank_select":
        b, n, d = w["B"], w["T"] * w["nb_max"], w["d"]
        nbytes = 4 * b * d + n * (4 * d + 4 + 1) + 8 * b * w["T"] * w["L"]
        return max(2.0 * b * n * d / F32_PEAK, nbytes / kernels.HBM_BPS)
    b, c, d, k = w["B"], w["c"], w["d"], w["k"]
    lists = 8 * b * w["n2"] if w["n2"] is not None else 9 * b * c
    nbytes = w["rows"] * (d * w["elem_bytes"] + 4 + 8) + lists + 4 * b * d + 12 * b * k
    return nbytes / kernels.HBM_BPS


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _length(intervals) -> float:
    return sum(e - s for s, e in _union(intervals))


def stages(trace: dict, requests: int) -> dict:
    """Per span name, per request: wall, self, sync and device ms, and the
    idle gaps by innermost span; from a Chrome trace's events."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    calls = sorted((e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                   key=lambda e: e["ts"])
    call_ts = [e["ts"] for e in calls]
    launch_of = {e["args"]["correlation"]: e for e in calls if "correlation" in e.get("args", {})}
    spans = sorted((e for e in ev if e.get("cat") == "cpu_op" and e["name"].startswith("arroy.")),
                   key=lambda e: (e["ts"], -e["dur"]))
    # each span's parent: the innermost span open at its start
    parent, open_ = {}, []
    for i, s in enumerate(spans):
        while open_ and spans[open_[-1]]["ts"] + spans[open_[-1]]["dur"] < s["ts"] + s["dur"]:
            open_.pop()
        parent[i] = open_[-1] if open_ else None
        open_.append(i)
    children_wall = [0.0] * len(spans)
    for i, p in parent.items():
        if p is not None:
            children_wall[p] += spans[i]["dur"]
    dev_by_span = [[] for _ in spans]
    for e in dev:
        call = launch_of.get(e.get("args", {}).get("correlation"))
        if call is None:
            continue
        for i, s in enumerate(spans):
            if s["tid"] == call["tid"] and s["ts"] <= call["ts"] <= s["ts"] + s["dur"]:
                dev_by_span[i].append((e["ts"], e["ts"] + e["dur"]))
    out: dict = {}
    for i, s in enumerate(spans):
        t0, t1 = s["ts"], s["ts"] + s["dur"]
        lo, hi = bisect.bisect_left(call_ts, t0), bisect.bisect_right(call_ts, t1)
        sync = sum(c["dur"] for c in calls[lo:hi]
                   if c["tid"] == s["tid"] and c["name"] in SYNC_CALLS)
        st = out.setdefault(s["name"], {"calls": 0, "wall_ms": 0.0, "self_ms": 0.0, "sync_ms": 0.0,
                                        "device_ms": 0.0})
        st["calls"] += 1
        st["wall_ms"] += s["dur"] / 1e3
        st["self_ms"] += (s["dur"] - children_wall[i]) / 1e3
        st["sync_ms"] += sync / 1e3
        st["device_ms"] += _length(dev_by_span[i]) / 1e3
    for st in out.values():
        for key in st:
            st[key] /= requests
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    kernel_ms = {n: sum(e["dur"] for e in dev if f in e["name"]) / 1e3
                 for n, f in FUNCTION.items()}
    gaps: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        name = max(inner, key=lambda s: s["ts"])["name"] if inner else "(no arroy span)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e3 / requests
    return {
        "stages": out,
        "idle_gaps_ms": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "busy_ms": _length(merged) / 1e3 / requests,
        "kernel_ms": {n: t / requests for n, t in kernel_ms.items() if t},
        "device_events": len(dev) / requests,
        "arroy_device_events": sum(e.get("cat") == "gpu_user_annotation"
                                   and e["name"].startswith("arroy.") for e in ev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--out", help="a JSON file to write the result to")
    args = ap.parse_args(argv)
    from arroy_tpu_torch.utils import profiling

    c = spec.load_cell(args.workload)
    cfg, traffic, k = c.config, c.traffic, c.config["k"]
    t0 = time.perf_counter()
    x, pool = data.vectors(cfg, args.seed, "cuda")
    sched = data.schedule(len(pool), traffic["batch"], args.seed)
    batches = [np.ascontiguousarray(pool[i]) for i in sched]
    allowed = (data.filter_ids(len(x), traffic["filter_share"], args.seed)
               if traffic.get("filter_share") else None)
    t_data = time.perf_counter() - t0
    with profiling.recording() as setup:
        _, reader = cell_mod._build(cfg, x, args.seed, "cuda")
        searcher = reader.searcher(k, candidates=allowed, **traffic["searcher"])
    for i in range(cell_mod.WARMUP_REQUESTS):
        ids, dists = searcher.device_fn(*searcher.prepare_queries(batches[i]))
        ids.cpu(), dists.cpu()
    torch.cuda.synchronize()

    window = loop.drive(searcher, batches, k, args.seconds)
    first = window.requests
    part = list(range(first, first + args.requests))

    def serve(n):
        dq = searcher.prepare_queries(batches[n % len(batches)])
        ids, dists = searcher.device_fn(*dq)
        return ids.cpu().numpy()[:, :k], dists.cpu().numpy()[:, :k]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # the profiler's own start-up, once
        serve(part[0])
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        traced = [serve(n) for n in part]
        traced_s = time.perf_counter() - t
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            found = stages(json.load(f), len(part))
    t = time.perf_counter()
    with profiling.counting() as works:
        replay = [serve(n) for n in part]
    replay_s = time.perf_counter() - t
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1], equal_nan=True)
               for a, b in zip(traced, replay))

    roofline = {}
    for n, names in ((3, ("gather_score",)), (4, ("traverse",)),
                     (5, ("cut_rescore", "rescore_topk")), (6, ("rank_select",))):
        least_ms = 1e3 * sum(least_seconds(w) for w in works
                             if w["kernel"] in names and w.get("route", "kernel") == "kernel"
                             ) / len(part)
        dev_ms = found["kernel_ms"].get(n, 0.0)
        if least_ms and dev_ms:
            roofline[f"k{n}"] = {"share_pct": 100.0 * least_ms / dev_ms, "least_ms": least_ms,
                                 "device_ms": dev_ms}
    by_kernel: dict = {}
    for w in works:
        by_kernel.setdefault(w["kernel"], []).append(w)
    setup_s: dict = {}
    for name, s, e, _ in setup:
        setup_s[name] = setup_s.get(name, 0.0) + (e - s) * 1e-9
    out = {
        "cell": c.name, "seed": args.seed, "card": run._power_limit(), "torch": torch.__version__,
        "route": searcher.route, "data_s": t_data, "setup_spans_s": setup_s,
        "window": {"requests": window.requests,
                   "ms_per_request": 1e3 * window.seconds / window.requests,
                   "prepare_ms": 1e3 * float(np.mean(window.prepare_s))},
        "traced": {"requests": len(part), "ms_per_request": 1e3 * traced_s / len(part), **found},
        "replay": {"seconds": replay_s, "same_answers": same,
                   "records": {name: {"per_request": len(v) / len(part), "first": v[0]}
                               for name, v in by_kernel.items()}},
        "roofline": roofline,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
