"""On-disk format migrations.

Counterpart of `arroy_tpu/upgrade.py`, step for step: an index that
either package wrote at 1.0.0 or 1.1.0 comes out at 1.2.0 in the same
state.  The reference ships three upgrade steps for its LMDB layout
(reference: src/upgrade.rs:26,150,183) with committed old-format assets
exercising them (src/tests/upgrade.rs:11-96).  The chain:

- **1.0.0 → 1.1.0** — v1.0.0 generations stored state either as plain
  ``*.npy`` files or as a ``state.atc`` container; v1.1.0 declares the
  CRC-checked native container the only store.  The migration rewrites
  the index as a fresh container generation (the loader already reads
  both layouts, like the reference's version-generic read codecs,
  src/node.rs:285-341, so the step is a re-encode — the same shape as
  the reference's 0.5→0.6 version-key rewrite, src/upgrade.rs:150-173).
- **1.1.0 → 1.2.0** — v1.1.0 permitted KIND_SPLIT nodes whose stored
  normal row is all-zero.  Such a node is semantically a random-side
  split (`normal: None`): its margin is identically the bias and every
  consumer that branches on `kind` (insert routing, stats
  dummy_normals, the probe packer) mis-classifies it.  v1.2.0 forbids
  the pattern; the migration rewrites offending nodes to
  KIND_SPLIT_NONE and repacks the normals matrix to live rows only —
  real node surgery, the analog of the reference's 0.6→0.7 zero-normal
  → ``None`` rewrite (reference: src/upgrade.rs:249-258).

`upgrade_index` is idempotent and transactional: the rewrite publishes a
new generation atomically, so a crash mid-upgrade leaves the readable
old format in place.
"""

from __future__ import annotations

import numpy as np

from .errors import UnknownVersion
from .models.forest import KIND_SPLIT, KIND_SPLIT_NONE
from .store.database import Database
from .version import (
    CURRENT_VERSION,
    OLDEST_READABLE_VERSION,
    V1_0_0,
    V1_1_0,
    Version,
)


def _npy_store_to_container(st) -> None:
    """1.0.0 → 1.1.0: nothing to transform in memory — the loader decoded
    the legacy layout already; committing the touched state re-encodes it
    as a container generation (persist._write_state's default store)."""


def _zero_normal_splits_to_none(st) -> None:
    """1.1.0 → 1.2.0: KIND_SPLIT nodes with an all-zero normal row become
    KIND_SPLIT_NONE and their dead rows are dropped from the normals
    matrix (reference: src/upgrade.rs:249-258 — `if normal.is_zero()`
    the split is rewritten with ``normal: None``).

    Query results are unchanged: a zero normal yields margin == bias ==
    0 for every query, which is exactly the KIND_SPLIT_NONE traversal
    behavior (both children explored at the parent's priority).  What
    changes is every `kind`-dispatched consumer: insert routing sends
    items to the smaller side instead of sign(0)-lockstep, stats counts
    the node under dummy_normals, and the serving engines skip the dead
    margin row.
    """
    f = st.forest
    split = np.nonzero(f.kind == KIND_SPLIT)[0]
    if f.normals is None or not split.size:
        return
    rows = f.ptr[split]
    # "all-zero stored row" covers both f32 normals and packed BQ words
    zero = ~np.any(f.normals[rows] != 0, axis=1)
    dead = split[zero]
    if not dead.size:
        return
    f.kind[dead] = KIND_SPLIT_NONE
    f.ptr[dead] = 0
    live = np.nonzero(f.kind == KIND_SPLIT)[0]
    live_rows = f.ptr[live]
    f.normals = f.normals[live_rows]
    f.aux = f.aux[live_rows]
    f.ptr[live] = np.arange(live.size, dtype=np.int32)


#: ordered chain of (from_version, to_version, migration_fn)
_MIGRATIONS: list[tuple[Version, Version, object]] = [
    (V1_0_0, V1_1_0, _npy_store_to_container),
    (V1_1_0, Version(1, 2, 0), _zero_normal_splits_to_none),
]


def upgrade_index(db: Database, index: int) -> None:
    """Bring one index up to CURRENT_VERSION (in-place, committed)."""
    with db.write() as wtxn:
        st = wtxn.state(index)
        if st is None:
            return
        v = st.version
        if v == CURRENT_VERSION:
            return
        if v < OLDEST_READABLE_VERSION or v > CURRENT_VERSION:
            raise UnknownVersion(str(v))
        st = wtxn.state_mut(index)
        for frm, to, fn in _MIGRATIONS:
            if st.version == frm:
                fn(st)
                st.version = to
        if st.version != CURRENT_VERSION:
            raise UnknownVersion(str(st.version))


def upgrade_all(db: Database) -> list[int]:
    """Upgrade every index in the database; returns those touched."""
    touched = []
    for index in db.read().indexes():
        st = db.read().state(index)
        if st is not None and st.version != CURRENT_VERSION:
            upgrade_index(db, index)
            touched.append(index)
    return touched
