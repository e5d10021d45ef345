"""Import vectors into a database and build the forest.

Reference: examples/import-vectors.rs (stdin import with --n-trees /
--seed / --append flags and build timers).  The items go in with one
bulk `add_items`; ``--append`` keeps the ordered per-item `append_item`.
"""

from __future__ import annotations

import argparse
import time

from ..store.database import Database
from ..writer import Writer
from ._common import add_db_args, read_vectors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_db_args(ap)
    ap.add_argument("vectors", nargs="?", default="-", help="file, .npy, or '-' for stdin")
    ap.add_argument("--dimensions", type=int, default=None)
    ap.add_argument("--n-trees", type=int, default=None)
    ap.add_argument("--split-after", type=int, default=None)
    ap.add_argument("--available-memory", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--append", action="store_true", help="use the ordered append fast path")
    args = ap.parse_args(argv)

    ids, x = read_vectors(args.vectors, args.dimensions)
    dims = x.shape[1]
    db = Database(args.db, device=args.device)
    w = Writer(db, args.index, dims, metric=args.distance)

    t0 = time.perf_counter()
    with db.write() as wtxn:
        if args.append:
            for i, v in zip(ids, x):
                w.append_item(wtxn, int(i), v)
        else:
            w.add_items(wtxn, ids, x)
        t_insert = time.perf_counter()
        b = w.builder(seed=args.seed)
        if args.n_trees is not None:
            b.n_trees(args.n_trees)
        if args.split_after is not None:
            b.split_after(args.split_after)
        if args.available_memory is not None:
            b.available_memory(args.available_memory)
        b.build(wtxn)
        t_build = time.perf_counter()
    print(f"inserted {len(ids)} x {dims}-d vectors in {t_insert - t0:.2f}s")
    print(f"built in {t_build - t_insert:.2f}s; committed")


if __name__ == "__main__":
    main()
