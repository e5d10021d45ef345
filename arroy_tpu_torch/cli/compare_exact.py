"""Recall/latency comparison of the forest vs exact search.

Reference: examples/compare_with_hnsw.rs (4,000 x 768-d euclidean,
top-5, ``search_k = 5 * n_trees * 20``, recall vs an HNSW oracle).  The
oracle here is the per-pair brute force (`exact_by_vectors`), exact by
construction.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..reader import Reader
from ..store.database import Database
from ..writer import Writer
from ._common import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=4000)
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--n-trees", type=int, default=10)
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--distance", default="euclidean")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--queries", type=int, default=256)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.m, args.dims)).astype(np.float32)

    db = Database(device=args.device)
    w = Writer(db, 0, args.dims, metric=args.distance)
    t0 = time.perf_counter()
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(args.m, dtype=np.uint32), x)
        w.builder(seed=args.seed).n_trees(args.n_trees).build(wtxn)
    print(f"build: {time.perf_counter() - t0:.2f}s")

    r = Reader.open(db.read(), 0, db, metric=args.distance)
    search_k = args.count * args.n_trees * 20
    queries = x[: args.queries]

    q = r.nns(args.count).search_k(search_k)
    q.by_vectors(queries)  # warmup
    t0 = time.perf_counter()
    got = q.by_vectors(queries)
    t_ann = time.perf_counter() - t0

    r.exact_by_vectors(queries, args.count)  # warmup
    t0 = time.perf_counter()
    exact = r.exact_by_vectors(queries, args.count)
    t_exact = time.perf_counter() - t0

    hits = sum(
        len(set(i for i, _ in g) & set(i for i, _ in e)) for g, e in zip(got, exact)
    )
    recall = hits / (len(queries) * args.count)
    print(f"forest: {len(queries) / t_ann:.0f} qps  recall@{args.count}={recall:.4f} "
          f"(search_k={search_k})")
    print(f"exact : {len(queries) / t_exact:.0f} qps  recall@{args.count}=1.0000")


if __name__ == "__main__":
    main()
