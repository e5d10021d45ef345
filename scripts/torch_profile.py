#!/usr/bin/env python3
"""Where the port's query time goes on one NVIDIA GPU.

Builds `chip_smoke.py`'s two configurations with the PyTorch port
(clustered corpus, seed 42, euclidean, 10 trees, top-10):

- exact: 100,000 x 768, 8 batches of 2048, searchers f32x1, bf16 and
  int8, plus the same corpus under "binary quantized cosine";
- probe: 262,144 x 768, 8 batches of 256, bf16 and int8 block tables at
  search_k 4000 (where both reach recall@10 0.95);
- traversal: the exact configuration's index, 8 batches of 256, the
  best-first traversal (`searcher(engine="forest")`) at search_k 2000,
  4000 and 8000, unfiltered and filtered at 10% of the ids (at least
  twice search_k, as `chip_smoke.py` phase 7 filters).

For each searcher it times the 8 batches with the host clock around work
that ends in `torch.cuda.synchronize()` (no profiler), then profiles the
same batches with `torch.profiler` and prints the device time by kernel
(device-side events only; the hand kernels tagged "[kernel N]", so the
exact searchers name kernel 1 and kernel 5, their stage 2), the
device-busy total and the idle share (1 - busy / unprofiled wall).

Run from the repository root on a machine with a card, naming the
slices to profile (all three by default):

    python3 scripts/torch_profile.py [exact] [probe] [traversal]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from chip_smoke import (  # noqa: E402
    B_PROBE, BATCH, D, K, M, M_PROBE, N_PROBE_BATCHES, N_TREES, make_corpus,
)

N_BATCHES = 8
#: the hand kernels' CUDA function names, as the consumer lines name them
HAND_KERNELS = {"fused_select_kernel": "kernel 1", "hamming_kernel": "kernel 2",
                "gather_score_kernel": "kernel 3", "traverse_kernel": "kernel 4",
                "rescore_kernel": "kernel 5"}  # rescore_kernel_{warp,block,split}
PROBE_SEARCH_K = 4000
TRAVERSAL_SEARCH_K = (2000, 4000, 8000)
SLICES = ("exact", "probe", "traversal")


def profile(label: str, s, batches) -> dict:
    """Print the searcher's wall, device time by kernel and idle share over
    `batches`; returns them (ms a batch, events a batch)."""
    dqs = [s.prepare_queries(b) for b in batches]
    for dq in dqs[:2]:  # warm-up
        s.device_fn(*dq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for dq in dqs:
        s.device_fn(*dq)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for dq in dqs:
            s.device_fn(*dq)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): operator events carry the
    # same device time again
    ka = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ka) / 1e3
    n, b = len(dqs), len(batches[0])
    print(f"\n== {label}: route {s.route}, {n} batches of {b} ==")
    launches = sum(e.count for e in ka) / n
    print(f"wall (no profiler) {wall / n:.3f} ms per batch, {n * b / (wall / 1e3):.1f} qps; "
          f"device busy {busy / n:.3f} ms per batch; idle share {1 - busy / wall:.3f}; "
          f"{launches:.0f} device events per batch")
    for e in sorted(ka, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        ms = e.self_device_time_total / 1e3
        hand = next((f"[{k}] " for f, k in HAND_KERNELS.items() if f in e.key), "")
        print(f"  {ms / n:8.3f} ms/batch  {100 * ms / busy:5.1f}%  x{e.count // n:<4d} "
              f"{hand}{e.key[:90]}", flush=True)
    return {"wall_ms": wall / n, "busy_ms": busy / n, "idle": 1 - busy / wall, "events": launches}


def build(path, metric, x):
    from arroy_tpu_torch import Database, Reader, Writer

    db = Database(path, device="cuda")
    w = Writer(db, 0, D, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
    return Reader.open(db.read(), 0, db, metric=metric)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    slices = sys.argv[1:] or SLICES
    if not set(slices) <= set(SLICES):
        print(f"slices are {SLICES}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        x = make_corpus(np.random.default_rng(42), M + BATCH * N_BATCHES, D)
        batches = [x[M + i * BATCH:M + (i + 1) * BATCH] for i in range(N_BATCHES)]
        if "exact" in slices or "traversal" in slices:
            r = build(f"{tmp}/exact", "euclidean", x[:M])
        if "exact" in slices:
            for prec in ("f32x1", "bf16", "int8"):
                profile(f"exact {prec}, {M} x {D}", r.searcher(K, engine="exact", precision=prec),
                        batches)
        if "traversal" in slices:
            small = [batches[0][i:i + B_PROBE] for i in range(0, BATCH, B_PROBE)]
            for sk in TRAVERSAL_SEARCH_K:
                n_f = min(max(M // 10, 2 * sk), M)
                cand = np.random.default_rng(5).choice(M, n_f, replace=False)
                for filt in (None, cand):
                    s = r.searcher(K, search_k=sk, engine="forest", candidates=filt)
                    fn = s.device_fn
                    what = "" if filt is None else f", filtered {n_f} ids"
                    profile(f"traversal, search_k {sk}{what}, pmax_small {fn.pmax_small}, "
                            f"q_cap_small {fn.q_cap_small}, {M} x {D}", s, small)
                    print(f"  last batch: pops max {int(fn.last_pops.max())}, mean "
                          f"{float(fn.last_pops.float().mean()):.1f}; fallbacks {fn.fallbacks}; "
                          f"re-score {fn.rescore_mode(B_PROBE)}", flush=True)
        if "exact" in slices:
            r = build(f"{tmp}/bq", "binary quantized cosine", x[:M])
            profile(f"exact BQ cosine, {M} x {D}", r.searcher(K, engine="exact"), batches)
        if "probe" not in slices:
            return 0
        r = None

        x = make_corpus(np.random.default_rng(42), M_PROBE + B_PROBE * N_PROBE_BATCHES, D)
        batches = [x[M_PROBE + i * B_PROBE:M_PROBE + (i + 1) * B_PROBE]
                   for i in range(N_PROBE_BATCHES)]
        r = build(f"{tmp}/probe", "euclidean", x[:M_PROBE])
        for dtype in ("bf16", "int8"):
            s = r.searcher(K, search_k=PROBE_SEARCH_K, engine="forest", probe_dtype=dtype)
            profile(f"probe {dtype}, search_k {PROBE_SEARCH_K}, L {s.device_fn.L}, "
                    f"{M_PROBE} x {D}", s, batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
