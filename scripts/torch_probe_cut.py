#!/usr/bin/env python3
"""Recall@10 of the leaf-probe engine against its re-score cut ``k2``, for
a built-in metric and a registered custom one, on one NVIDIA GPU.

Run from the repository root:

    PYTHONPATH=. python3 scripts/torch_probe_cut.py [--items N] [--device cuda] [--shares 2,4,8,16]

The corpus is `chip_smoke.py` phase 10's: `sample_vectors`' model with 64
parents (bench.py's clustered corpus), seed 42, 768-d, and 2048 queries of
the same parents.  Two indexes of 10 trees are built over it: euclidean,
and "half-euclidean" (euclidean's formulas under another name, registered
with `register_metric`, which the probe scores in-block by the dot product
of the generic branch).  For each search_k of 2000·2ⁿ, each index is
probed (`traversal="probe"`, default tables) at the JAX package's cut
(`probe.JAX_CUT`: 512 candidates for both) and at the port's
(`probe.rescore_cut`: search_k over `probe.CUT_SHARE` past the floor of
512, half of search_k past 1536 for the custom metric's estimate), once
for each share of ``--shares`` (default: the module's).  Prints one JSON
line each, with recall@10
against the euclidean index's f32x1 exact search, qps over the 2048
queries in batches of 256 (CUDA events after a warm-up batch), and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

K, D, TREES, B = 10, 768, 10, 2048


def main() -> int:
    import torch

    from arroy_tpu_torch import Database, Reader, Writer, internals, probe
    from arroy_tpu_torch.cli import sample_vectors
    from arroy_tpu_torch.metrics import Euclidean

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--items", type=int, default=262_144)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shares", default=str(probe.CUT_SHARE),
                    help="comma-separated values of probe.CUT_SHARE to measure the port's cut at")
    args = ap.parse_args()
    shares = [int(v) for v in args.shares.split(",")]
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    else:
        smi = f"{args.device} (no card)"

    class HalfEuclidean(Euclidean):
        name = "half-euclidean"

    internals.register_metric(HalfEuclidean)
    with tempfile.TemporaryDirectory() as tmp:
        model = ["--dimensions", str(D), "--parents", "64", "--seed", "42"]
        sample_vectors.main(["--count", str(args.items), "-o", f"{tmp}/x.npy"] + model)
        sample_vectors.main(["--count", str(B), "-o", f"{tmp}/q.npy"] + model)
        x, q = np.load(f"{tmp}/x.npy"), np.load(f"{tmp}/q.npy")
    readers = {}
    for metric in ("euclidean", "half-euclidean"):
        db = Database(device=args.device)
        w = Writer(db, 0, D, metric=metric)
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(args.items, dtype=np.uint32), x)
            w.builder(seed=42).n_trees(TREES).build(wtxn)
        readers[metric] = Reader.open(db.read(), 0, db, metric=metric)
    batches = [q[i:i + 256] for i in range(0, B, 256)]

    def ids_of(s):
        """(ids of every batch, qps): CUDA events around the batches after
        a warm-up batch (a host clock on the CPU)."""
        dqs = [s.prepare_queries(b) for b in batches]
        s.device_fn(*dqs[0])
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            res = [s.device_fn(*dq) for dq in dqs]
            e1.record()
            torch.cuda.synchronize()
            sec = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            res = [s.device_fn(*dq) for dq in dqs]
            sec = time.perf_counter() - t0
        return np.concatenate([i[:, :K].cpu().numpy() for i, _ in res]), B / sec

    ref, _ = ids_of(readers["euclidean"].searcher(K, engine="exact", precision="f32x1"))
    for sk in (2000, 4000, 8000, 16000, 32000):
        for metric, r in readers.items():
            # the custom metric's estimate takes half of search_k at any share
            ports = shares if metric == "euclidean" else shares[:1]
            for cut, share in [("jax", None)] + [("port", v) for v in ports]:
                probe.JAX_CUT, saved = cut == "jax", probe.CUT_SHARE
                probe.CUT_SHARE = share or saved
                try:
                    s = r.searcher(K, search_k=sk, engine="forest", traversal="probe")
                finally:
                    probe.JAX_CUT, probe.CUT_SHARE = False, saved
                fn = s.device_fn
                got, qps = ids_of(s)
                rc = sum(len(set(a) & set(b)) for a, b in zip(got, ref)) / ref.size
                print(json.dumps({"items": args.items, "metric": metric, "search_k": sk,
                                  "L": fn.L, "cut": cut, "share": share, "k2": fn.k2,
                                  "recall": rc, "qps": qps, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
