"""Dump the first tree as graphviz dot (reference: examples/graph.rs)."""

from __future__ import annotations

import argparse
import sys

from ..reader import Reader
from ..store.database import Database
from ._common import add_db_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_db_args(ap)
    ap.add_argument("-o", "--output", default="-")
    args = ap.parse_args(argv)

    db = Database(args.db, device=args.device)
    r = Reader.open(db.read(), args.index, db, metric=args.distance)
    dot = r.plot_internals_tree_nodes()
    if args.output == "-":
        sys.stdout.write(dot)
    else:
        with open(args.output, "w") as f:
            f.write(dot)


if __name__ == "__main__":
    main()
