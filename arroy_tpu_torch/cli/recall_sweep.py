"""Recall@k vs search_k vs QPS sweep (the ann-benchmarks-style curve).

The quality/throughput tradeoff harness from SURVEY §7.9: builds a
corpus (clustered crossover like the reference's sample generator, or
isotropic gaussian, or a .npy file) and sweeps `search_k`.  Each point is
timed over 10 batches after a warm-up one: with CUDA events on a card,
with the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..reader import Reader
from ..store.database import Database
from ..writer import Writer
from ._common import add_device_arg


def _elapsed_s(device, fn) -> float:
    """Seconds `fn()` takes on `device`: CUDA events around it on a card
    (the work `fn` queued is finished when the clock stops), the host
    clock elsewhere."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=20_000)
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--n-trees", type=int, default=10)
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--distance", default="euclidean")
    ap.add_argument(
        "--data", choices=["clustered", "random", "glove"], default="clustered",
        help="glove = GloVe-100-class stand-in: Zipf-sized anisotropic "
        "clusters with per-cluster scale spread (offline image, so the "
        "real ann-benchmarks download is synthesized; see BASELINE.md)",
    )
    ap.add_argument("--vectors", default=None, help="optional .npy corpus")
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--search-k", type=int, nargs="*", default=None,
        help="explicit sweep points (default: a geometric ladder)",
    )
    ap.add_argument(
        "--db", default=None,
        help="persist the index at this path and reuse it when present",
    )
    ap.add_argument(
        "--exact-point", action="store_true",
        help="also measure the exact engine (the recall-1.0 endpoint)",
    )
    ap.add_argument(
        "--multipop", default="auto",
        help="forest pops per traversal iteration (1 = strict best-first "
        "= auto; above 1 is not ported and raises)",
    )
    ap.add_argument(
        "--traversal", default="auto", choices=("auto", "xla", "probe"),
        help="forest traversal mode (see search.traversal_mode; probe = "
        "centroid-ranked leaf-block probing, see probe.py)",
    )
    ap.add_argument("--probe-trees", default="auto")
    ap.add_argument("--probe-block", default="auto")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.vectors:
        x = np.load(args.vectors).astype(np.float32)
        m, dims = x.shape
        q = x[rng.integers(m, size=args.queries)]
    else:
        m, dims = args.m, args.dims
        n = m + args.queries
        if args.data == "clustered":
            parents = rng.standard_normal((64, dims)).astype(np.float32)
            pa, pb = rng.integers(64, size=n), rng.integers(64, size=n)
            mask = rng.random((n, dims)) < 0.5
            allx = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
            allx += 0.05 * rng.standard_normal((n, dims)).astype(np.float32)
        elif args.data == "glove":
            # GloVe-100-class stand-in: word-embedding corpora are a
            # heavy-tailed mixture — a few huge diffuse topic clusters
            # and a long tail of tight ones, anisotropic (embedding
            # energy concentrates in a low-rank subspace), with a wide
            # per-vector norm spread.  Zipf cluster sizes + per-cluster
            # random low-rank covariance + lognormal norms reproduce
            # those statistics; queries are drawn from the same mixture
            # (ann-benchmarks holds out corpus-distributed test points).
            n_clusters = 1024
            sizes = rng.zipf(1.3, size=n_clusters).astype(np.float64)
            probs = sizes / sizes.sum()
            rank = max(dims // 4, 4)
            basis = rng.standard_normal((rank, dims)).astype(np.float32)
            centers = (
                rng.standard_normal((n_clusters, rank)).astype(np.float32) @ basis
            )
            scales = np.exp(rng.normal(-0.7, 0.5, n_clusters)).astype(np.float32)
            cl = rng.choice(n_clusters, size=n, p=probs)
            allx = centers[cl] + scales[cl][:, None] * (
                rng.standard_normal((n, rank)).astype(np.float32) @ basis
                + 0.1 * rng.standard_normal((n, dims)).astype(np.float32)
            )
            allx *= np.exp(rng.normal(0.0, 0.4, n)).astype(np.float32)[:, None]
        else:
            allx = rng.standard_normal((n, dims)).astype(np.float32)
        x, q = allx[:m], allx[m:]

    db = Database(args.db, device=args.device)
    w = Writer(db, 0, dims, metric=args.distance)
    st = db.read().state(0) if args.db else None
    have = (
        st is not None
        and st.metadata is not None
        and st.metadata.dimensions == dims
        and len(st.metadata.items) == m
        and len(st.metadata.roots) == args.n_trees
        and not st.updated
    )
    if have:
        print(f"reusing persisted index at {args.db}", flush=True)
    else:
        t0 = time.perf_counter()
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
            w.builder(seed=args.seed).n_trees(args.n_trees).build(wtxn)
        print(f"build: {time.perf_counter() - t0:.1f}s ({m} x {dims}, "
              f"{args.n_trees} trees)", flush=True)

    r = Reader.open(db.read(), 0, db, metric=args.distance)
    exact = r.exact_by_vectors(q, args.count)
    ex_sets = [set(i for i, _ in e) for e in exact]

    def measure(s, label):
        dq = s.prepare_queries(q)
        s.device_fn(*dq)  # warm-up
        iters = 10
        outs = []
        dt = _elapsed_s(args.device, lambda: outs.extend(s.device_fn(*dq) for _ in range(iters)))
        ids = outs[-1][0].cpu().numpy()[:, : args.count]
        dists = outs[-1][1].cpu().numpy()[:, : args.count]
        got = [
            set(int(i) for i, d in zip(ri, rd) if not np.isnan(d))
            for ri, rd in zip(ids, dists)
        ]
        rec = float(np.mean([len(g & e) / args.count for g, e in zip(got, ex_sets)]))
        print(
            f"{label}  recall@{args.count}={rec:.4f}  "
            f"qps={iters * len(q) / dt:9.0f}",
            flush=True,
        )

    points = args.search_k or [
        args.count * args.n_trees * f for f in (1, 5, 20, 50, 100, 200)
    ]
    mp = args.multipop if args.multipop == "auto" else int(args.multipop)
    pt = args.probe_trees if args.probe_trees == "auto" else int(args.probe_trees)
    pb = args.probe_block if args.probe_block == "auto" else int(args.probe_block)
    for sk in points:
        measure(
            r.searcher(
                args.count, search_k=sk, engine="forest", multipop=mp,
                traversal=args.traversal, probe_trees=pt, probe_block=pb,
            ),
            f"search_k={sk:>7}",
        )
    if args.exact_point:
        measure(r.searcher(args.count, engine="exact"), "exact          ")


if __name__ == "__main__":
    main()
