#!/usr/bin/env python3
"""Recall@10 of the leaf-probe engine against its re-score cut ``k2``, for
a built-in metric and a registered custom one, on one NVIDIA GPU.

Run from the repository root:

    PYTHONPATH=. python3 scripts/torch_probe_cut.py [--items N] [--device cuda]

The corpus is `chip_smoke.py` phase 10's: `sample_vectors`' model with 64
parents (bench.py's clustered corpus), seed 42, 768-d, and 2048 queries of
the same parents.  Two indexes of 10 trees are built over it: euclidean,
and "half-euclidean" (euclidean's formulas under another name, registered
with `register_metric`, which the probe scores in-block by the dot product
of the generic branch).  For each search_k of 2000·2ⁿ, each index is
probed (`traversal="probe"`, default tables) at two cuts: the plain one
(512 candidates) and the estimate's (half of search_k, at least 1536).
Prints one JSON line each, with recall@10 against the euclidean index's
f32x1 exact search, the cut each metric takes by default, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

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
    args = ap.parse_args()
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
        return np.concatenate([s.device_fn(*s.prepare_queries(b))[0][:, :K].cpu().numpy()
                               for b in batches])

    ref = ids_of(readers["euclidean"].searcher(K, engine="exact", precision="f32x1"))
    for sk in (2000, 4000, 8000, 16000, 32000):
        for metric, r in readers.items():
            s = r.searcher(K, search_k=sk, engine="forest", traversal="probe")
            fn = s.device_fn
            pool = fn.tables.n_trees * fn.L * fn.tables.block
            default = fn.k2
            for cut, k2 in (("plain", min(512, pool)),
                            ("estimate", min(probe._next_pow2(max(1536, sk // 2)), pool))):
                fn.k2 = k2
                got = ids_of(s)
                rc = sum(len(set(a) & set(b)) for a, b in zip(got, ref)) / ref.size
                print(json.dumps({"items": args.items, "metric": metric, "search_k": sk,
                                  "L": fn.L, "cut": cut, "k2": k2, "default_k2": default,
                                  "recall": rc, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
