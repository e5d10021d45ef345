"""Print index statistics (reference: examples/stats.rs)."""

from __future__ import annotations

import argparse

from ..reader import Reader
from ..store.database import Database
from ._common import add_db_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_db_args(ap)
    args = ap.parse_args(argv)

    db = Database(args.db, device=args.device)
    r = Reader.open(db.read(), args.index, db, metric=args.distance)
    s = r.stats()
    print(f"index {args.index}: {s.leaf} items, {len(s.tree_stats)} trees, "
          f"{r.dimensions()} dims, version {r.version()}")
    for i, ts in enumerate(s.tree_stats):
        print(
            f"  tree {i}: depth={ts.depth} splits={ts.split_nodes} "
            f"descendants={ts.descendants} dummy_normals={ts.dummy_normals}"
        )
    depths = [ts.depth for ts in s.tree_stats]
    if depths:
        print(f"depth: min={min(depths)} max={max(depths)} "
              f"avg={sum(depths) / len(depths):.1f}")
    # host-side pack (no device upload): same arrays the device would hold
    from ..device import DeviceIndex

    st = r._state
    pack = DeviceIndex.build_np(r.metric, r.dimensions(), st.store, st.forest)
    hbm = sum(a.nbytes for a in pack.values() if hasattr(a, "nbytes"))
    print(f"device (HBM) footprint: {hbm / (1 << 20):.1f} MiB")


if __name__ == "__main__":
    main()
