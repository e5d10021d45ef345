"""Query-latency benchmark over a built database.

Reference: examples/search_movies.rs (nns(k) by_item over every item;
avg / min / max / stddev latency).  Adds a batched mode — the shape a
card serves.  Both run `nns()`, which never probes (it has no host
snapshot to pack block tables from), so ``--traversal probe`` walks the
traversal as ``xla`` does, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..reader import Reader
from ..store.database import Database
from ._common import add_db_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_db_args(ap)
    ap.add_argument("--count", type=int, default=20)
    ap.add_argument("--search-k", type=int, default=None)
    ap.add_argument("--batch", type=int, default=0, help="0 = one-by-one latency mode")
    ap.add_argument("--limit", type=int, default=1000, help="max items to query")
    ap.add_argument(
        "--traversal",
        choices=("auto", "xla", "probe"),
        default="auto",
        help="traversal engine (see search.traversal_mode)",
    )
    args = ap.parse_args(argv)
    # the tool sets ARROY_TRAVERSAL for its own run only (it may run
    # in-process beside other work)
    saved = os.environ.get("ARROY_TRAVERSAL")
    if args.traversal != "auto":
        os.environ["ARROY_TRAVERSAL"] = args.traversal
    try:
        _bench(args)
    finally:
        if saved is None:
            os.environ.pop("ARROY_TRAVERSAL", None)
        else:
            os.environ["ARROY_TRAVERSAL"] = saved


def _bench(args):
    db = Database(args.db, device=args.device)
    r = Reader.open(db.read(), args.index, db, metric=args.distance)
    ids = list(r.item_ids())[: args.limit]
    q = r.nns(args.count)
    if args.search_k:
        q.search_k(args.search_k)

    if args.batch:
        q.by_items(np.asarray(ids[: args.batch]))  # warmup/compile
        t0 = time.perf_counter()
        n = 0
        for off in range(0, len(ids), args.batch):
            chunk = ids[off : off + args.batch]
            q.by_items(np.asarray(chunk))
            n += len(chunk)
        dt = time.perf_counter() - t0
        print(f"{n} queries in {dt:.3f}s -> {n / dt:.0f} qps (batch={args.batch})")
        return

    q.by_item(ids[0])  # warmup/compile
    times = []
    for i in ids:
        t0 = time.perf_counter()
        q.by_item(i)
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    print(
        f"{len(ids)} queries: avg={t.mean() * 1e3:.2f}ms min={t.min() * 1e3:.2f}ms "
        f"max={t.max() * 1e3:.2f}ms stddev={t.std() * 1e3:.2f}ms"
    )


if __name__ == "__main__":
    main()
