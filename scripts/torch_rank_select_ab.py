#!/usr/bin/env python3
"""Kernel 6 (the probe's stage 1, `ops.rank_select`) in turns with the
plain chain it replaced, on one card: where the route rule's crossover
lies, and what a probe searcher pays for either route.

1. `--sweep`: random tables (cosine unit centroids, 3% of the blocks not
   valid) over a grid of (T, nb_max) x d x L x B; at each shape the
   kernel and the plain chain (`rank_blocks_reference`) forced through
   `rank_blocks`' route, device ms in turns kernel, plain, kernel, plain
   (`chip_smoke.device_ms`: the calls queued behind a spin kernel), and
   the route `ops.rank_select.uses_kernel` picks.
2. `--probe`: the probe over 262,144 x 768 (`chip_smoke.py` phase 6's
   corpus and index), its own tables and search_k at B = 256 (phase 6's
   batches) and B = 2048, stage 1 forced to the plain chain (what the
   probe ran before kernel 6), to the kernel, and routed by the rule, in
   turns plain, kernel, rule, rule, kernel, plain.  Each turn: wall a
   batch (host clock, ending in `synchronize`), device busy and events a
   batch (`torch.profiler`), kernel 6's launches a batch and recall@10
   against the f32x1 exact engine on the same batches.

One JSON line a shape or a turn, and a last JSON record of all of them.
Run from the repository root on a machine with a card:

    python3 scripts/torch_rank_select_ab.py [--sweep [--trees TxNB ...] [--dims D ...]
        [--ls L ...] [--batches B ...]] [--probe] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arroy_tpu_torch.ops import rank_select as rs  # noqa: E402

#: (T, nb_max): the probe cell's trees (glove-100's 1.18M items) and
#: phase 6's (262,144 items)
TREES = ((8, 23_100), (4, 8_192))
DIMS = (100, 256, 512, 768, 1536)
LS = (25, 64)
BATCHES = (16, 40, 64, 128, 256, 512, 1024, 2048)
#: the probe searchers of step 2: (table type, search_k)
PROBE_RUNS = (("auto", 2000), ("auto", 4000), ("int8", 4000))
TURNS = ("plain", "kernel", "rule", "rule", "kernel", "plain")


def route(mode):
    """Stage 1 forced to the kernel or the plain chain ("rule": as routed)."""
    return contextlib.nullcontext() if mode == "rule" else cs.stage1_route(mode)


def sweep(out, trees=TREES, dims=DIMS, ls=LS, batches=BATCHES):
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    for T, nb in trees:
        for d in dims:
            cent = torch.randn((T * nb, d), device=dev, generator=gen.manual_seed(d))
            cent /= cent.norm(dim=1, keepdim=True)
            caux = torch.zeros(T * nb, device=dev)
            valid = torch.rand(T * nb, device=dev, generator=gen) >= 0.03
            for L in ls:
                for b in batches:
                    q = torch.randn((b, d), device=dev, generator=gen)
                    args = (q, cent, caux, valid, 1, L, nb)
                    times = {"kernel": [], "plain": []}
                    for mode in ("kernel", "plain", "kernel", "plain"):
                        with route(mode):
                            times[mode].append(cs.device_ms(lambda: rs.rank_blocks(*args),
                                                            10 if mode == "kernel" else 3))
                    k, p = min(times["kernel"]), min(times["plain"])
                    row = dict(T=T, nb_max=nb, d=d, L=L, B=b, kernel_ms=k, plain_ms=p,
                               turns=times, faster="kernel" if k < p else "plain",
                               rule="kernel" if rs.uses_kernel(b, L, d, T * nb, dev) else "plain")
                    print(json.dumps(row), flush=True)
                    out.append(row)
            del cent, caux, valid


def measure(label, s, dqs, ref_ids):
    """Wall, busy, events and kernel 6's launches a batch over the batches
    `dqs`, after a warm-up batch; recall@10 against `ref_ids`."""
    s.device_fn(*dqs[0])
    torch.cuda.synchronize()
    n0, p0 = rs.launches["rank_select"], rs.plain_calls["rank_blocks"]
    t0 = time.perf_counter()
    res = [s.device_fn(*dq) for dq in dqs]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(dqs)
    launches = (rs.launches["rank_select"] - n0) / len(dqs)
    plain = (rs.plain_calls["rank_blocks"] - p0) / len(dqs)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for dq in dqs:
            s.device_fn(*dq)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / len(dqs)
    k6 = sum(e.self_device_time_total for e in ev if "rank_select_kernel" in e.key) / 1e3 / len(dqs)
    ids = np.concatenate([r[0][:, :cs.K].cpu().numpy() for r in res])
    rec = dict(label=label, wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
               device_events=sum(e.count for e in ev) / len(dqs), kernel6_ms=k6,
               kernel6_launches=launches, plain_calls=plain, recall=cs.recall_of(ids, ref_ids))
    print(json.dumps(rec), flush=True)
    return rec


def probe(tmp, out):
    from scripts.torch_rescore_ab import build_index

    n_q = cs.B_PROBE * cs.N_PROBE_BATCHES
    x = cs.make_corpus(np.random.default_rng(42), cs.M_PROBE + n_q, cs.D)
    queries = x[cs.M_PROBE:]
    r = build_index(f"{tmp}/probe", x[:cs.M_PROBE])
    ex = r.searcher(cs.K, engine="exact", precision="f32x1")
    ref_ids = np.concatenate([ex.device_fn(*ex.prepare_queries(queries[i:i + cs.B_PROBE]))[0]
                              [:, :cs.K].cpu().numpy() for i in range(0, n_q, cs.B_PROBE)])
    for dtype, sk in PROBE_RUNS:
        s = r.searcher(cs.K, search_k=sk, engine="forest", probe_dtype=dtype)
        assert s.route == "probe", s.route
        t = s.device_fn.tables
        for b in (cs.B_PROBE, n_q):
            dqs = [s.prepare_queries(queries[i:i + b]) for i in range(0, n_q, b)]
            label = (f"probe {str(t.blk_rows.dtype).replace('torch.', '')} tables, search_k {sk}, "
                     f"T {t.n_trees}, nb_max {t.nb_max}, L {s.device_fn.L}, d {cs.D}, B={b}")
            for i, mode in enumerate(TURNS):
                with route(mode):
                    rec = measure(f"{label}, {mode} (turn {i + 1})", s, dqs, ref_ids)
                rec.update(searcher=label, mode=mode, turn=i + 1)
                out.append(rec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="step 1, the shapes")
    ap.add_argument("--probe", action="store_true", help="step 2, the probe searchers")
    ap.add_argument("--trees", nargs="+", default=[f"{t}x{nb}" for t, nb in TREES],
                    help="the sweep's tables, T x nb_max")
    ap.add_argument("--dims", type=int, nargs="+", default=DIMS, help="the sweep's widths")
    ap.add_argument("--ls", type=int, nargs="+", default=LS, help="the sweep's L")
    ap.add_argument("--batches", type=int, nargs="+", default=BATCHES, help="the sweep's B")
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rank_select_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rs._lib()
    out = {"card": smi, "sweep": [], "probe": []}
    if args.sweep:
        trees = [tuple(int(v) for v in t.split("x")) for t in args.trees]
        sweep(out["sweep"], trees, args.dims, args.ls, args.batches)
    if args.probe:
        with tempfile.TemporaryDirectory() as tmp:
            probe(tmp, out["probe"])
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
