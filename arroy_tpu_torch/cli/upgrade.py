"""Upgrade a database to the current on-disk format.

The CLI face of `arroy_tpu_torch.upgrade` (reference role: the `upgrade`
module a deployment calls between releases, src/upgrade.rs).

    python -m arroy_tpu_torch.cli.upgrade --db PATH [--index N] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..store.database import Database
from ..upgrade import upgrade_all, upgrade_index
from ..version import CURRENT_VERSION
from ._common import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", required=True)
    ap.add_argument(
        "--index", type=int, default=None, help="one index (default: all)"
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)

    db = Database(args.db, device=args.device)
    if args.index is not None:
        st = db.read().state(args.index)
        if st is None:
            print(f"index {args.index}: does not exist")
            return
        before = st.version
        upgrade_index(db, args.index)
        print(f"index {args.index}: {before} -> {CURRENT_VERSION}")
    else:
        touched = upgrade_all(db)
        if touched:
            print(f"upgraded indexes {touched} -> {CURRENT_VERSION}")
        else:
            print(f"all indexes already at {CURRENT_VERSION}")


if __name__ == "__main__":
    main()
