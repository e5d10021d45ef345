"""Integrity check: container CRCs + forest validity invariants.

Combines the reference's `assert-reader-validity` feature
(reference: src/reader.rs:501-589) with storage-level CRC verification
of the native container — the fsck of arroy-tpu databases.
"""

from __future__ import annotations

import argparse
import json
import os

from ..native import Container
from ..reader import Reader
from ..store.database import Database
from ._common import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", required=True)
    ap.add_argument("--index", type=int, default=None, help="default: all indexes")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    # storage-level: verify every live generation container
    manifest = json.load(open(os.path.join(args.db, "MANIFEST.json")))
    for key, info in manifest.get("indexes", {}).items():
        gen_dir = os.path.join(args.db, f"idx_{int(key):05d}", f"gen_{info['gen']:08d}")
        atc = os.path.join(gen_dir, "state.atc")
        if os.path.exists(atc):
            with Container(atc, verify=True):
                pass
            print(f"index {key}: container CRCs OK")

    db = Database(args.db, device=args.device)
    rtxn = db.read()
    indexes = [args.index] if args.index is not None else rtxn.indexes()
    for idx in indexes:
        st = rtxn.state(idx)
        if st is None:
            print(f"index {idx}: missing")
            continue
        if st.metadata is None:
            print(f"index {idx}: not built yet ({len(st.store)} items pending)")
            continue
        if st.updated:
            print(f"index {idx}: {len(st.updated)} pending updates (NeedBuild)")
            continue
        r = Reader.open(rtxn, idx, db, metric=st.metric)
        r.assert_validity()
        print(
            f"index {idx}: structure OK - {r.n_items()} items, "
            f"{r.n_trees()} trees, {r.dimensions()} dims, v{r.version()}"
        )


if __name__ == "__main__":
    main()
