"""Build the forest without committing — timing/debug tool.

Reference: examples/build-tree-no-commit.rs (build inside a txn that is
aborted, printing the build timer).
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
    ap.add_argument("vectors", nargs="?", default=None,
                    help="optional vectors to import first (file/.npy/'-')")
    ap.add_argument("--n-trees", type=int, default=None)
    ap.add_argument("--split-after", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    db = Database(args.db, device=args.device)
    wtxn = db.write()
    try:
        if args.vectors is not None:
            ids, x = read_vectors(args.vectors)
            w = Writer(db, args.index, x.shape[1], metric=args.distance)
            w.add_items(wtxn, ids, x)
        else:
            st = wtxn.state(args.index)
            if st is None:
                raise SystemExit(f"index {args.index} does not exist in {args.db}")
            w = Writer(db, args.index, st.dims, metric=args.distance)
        b = w.builder(seed=args.seed)
        if args.n_trees is not None:
            b.n_trees(args.n_trees)
        if args.split_after is not None:
            b.split_after(args.split_after)
        t0 = time.perf_counter()
        b.build(wtxn)
        print(f"built in {time.perf_counter() - t0:.2f}s (NOT committed)")
    finally:
        wtxn.abort()


if __name__ == "__main__":
    main()
