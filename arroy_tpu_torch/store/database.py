"""The Database: multi-index container with MVCC transactions.

The reference is embedded in LMDB: up to 65536 u16-indexed sub-indexes
share one database, a single writer mutates inside an `RwTxn` while any
number of readers keep consistent snapshots, and commit is the atomic
publication point (reference: src/lib.rs:1-3, src/key.rs:19-25,
README.md:16,28-37).

Here the same contract is provided natively: the Database holds an
immutable committed snapshot (dict of `IndexState`); a `WriteTxn` works
on copy-on-write clones and `commit()` swaps the snapshot pointer (and,
for file-backed databases, atomically publishes a new generation on
disk via `persist`).  Readers opened on a snapshot keep it alive
regardless of later commits — queries during writes see the committed
state, exactly like LMDB MVCC.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..errors import ArroyError
from ..metrics import Metric, resolve_metric
from ..models.forest import Forest
from ..models.items import ItemStore
from ..utils.itemset import ItemSet
from ..version import CURRENT_VERSION, Version

MAX_INDEX = 0xFFFF


@dataclass
class Metadata:
    """Per-index header (reference: src/metadata.rs:12-17)."""

    dimensions: int
    items: ItemSet
    roots: list[int]
    distance: str


@dataclass
class IndexState:
    """Everything stored for one u16 sub-index."""

    dims: int
    metric: type[Metric]
    store: ItemStore
    #: the Updated key set: ids touched since the last build
    #: (reference: src/writer.rs:380-394, drained at src/writer.rs:891-914)
    updated: set[int] = field(default_factory=set)
    forest: Forest = field(default_factory=Forest)
    metadata: Optional[Metadata] = None
    version: Version = CURRENT_VERSION
    generation: int = 0

    def clone(self) -> "IndexState":
        return IndexState(
            dims=self.dims,
            metric=self.metric,
            store=self.store.clone(),
            updated=set(self.updated),
            forest=self.forest.clone(),
            metadata=None
            if self.metadata is None
            else Metadata(
                self.metadata.dimensions,
                self.metadata.items,
                list(self.metadata.roots),
                self.metadata.distance,
            ),
            version=self.version,
            generation=self.generation,
        )


class Database:
    """An embedded multi-index vector database (the `heed::Database` role).

    File-backed databases follow the LMDB concurrency contract
    (reference: README.md:16,28-37): many reader processes share the
    files, one writer at a time holds an advisory file lock, and every
    `read()` sees the latest committed generation.
    """

    def __init__(self, path: str | None = None, device="cuda"):
        self.path = path
        #: the one place a device is chosen: every Writer, Reader and
        #: DeviceIndex of this database works on it
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._committed: dict[int, IndexState] = {}
        self._device_cache: dict[int, tuple[int, object]] = {}
        self._manifest_stamp: tuple | None = None
        if path is not None:
            from . import persist

            self._committed = persist.load(path)
            self._manifest_stamp = self._stat_manifest()

    def _stat_manifest(self):
        import os

        if self.path is None:
            return None
        try:
            st = os.stat(os.path.join(self.path, "MANIFEST.json"))
            return (st.st_mtime_ns, st.st_size)
        except FileNotFoundError:
            return None

    def _maybe_reload(self) -> None:
        """Pick up commits made by other processes (LMDB MVCC reopen)."""
        if self.path is None:
            return
        stamp0 = self._manifest_stamp
        stamp = self._stat_manifest()
        if stamp == stamp0:
            return
        from . import persist

        fresh = persist.load(self.path)
        with self._lock:
            if self._manifest_stamp != stamp0:
                # a local commit raced this reload; its snapshot is newer
                # than `fresh` — dropping indexes based on the stale disk
                # state would un-commit it (non-monotonic read)
                return
            for idx, st in fresh.items():
                cur = self._committed.get(idx)
                if cur is None or st.generation > cur.generation:
                    self._committed[idx] = st
            for idx in list(self._committed):
                if idx not in fresh:
                    self._committed.pop(idx)
                    self._device_cache.pop(idx, None)
            self._manifest_stamp = stamp

    def close(self) -> None:
        """Release the snapshot and device cache (the `heed::Env` close role).

        Any later transaction on this handle raises; reopen by
        constructing a new `Database` on the same path.
        """
        with self._lock:
            self._committed = {}
            self._device_cache = {}
            self._closed = True

    # -- transactions --------------------------------------------------
    def write(self) -> "WriteTxn":
        if getattr(self, "_closed", False):
            raise ArroyError("database is closed")
        return WriteTxn(self)

    def read(self) -> "ReadTxn":
        if getattr(self, "_closed", False):
            raise ArroyError("database is closed")
        self._maybe_reload()
        with self._lock:
            return ReadTxn(self, dict(self._committed))

    def _publish(self, states: dict[int, IndexState], dropped: set[int]) -> None:
        with self._lock:
            new = dict(self._committed)
            for idx in dropped:
                new.pop(idx, None)
                self._device_cache.pop(idx, None)
            new.update(states)
            if self.path is not None:
                from . import persist

                persist.save(self.path, new)
            self._committed = new
            self._manifest_stamp = self._stat_manifest()

    # -- device cache --------------------------------------------------
    def device_index(self, index: int, state: IndexState):
        """Lazily build and cache the device mirror of a committed state."""
        from ..device import DeviceIndex

        with self._lock:
            hit = self._device_cache.get(index)
            if hit is not None and hit[0] == state.generation:
                return hit[1]
        dev = DeviceIndex.build(
            state.metric, state.dims, state.store, state.forest, self.device
        )
        with self._lock:
            self._device_cache[index] = (state.generation, dev)
        return dev


class ReadTxn:
    """A consistent snapshot of the committed database."""

    def __init__(self, db: Database, states: dict[int, IndexState]):
        self.db = db
        self._states = states

    def state(self, index: int) -> Optional[IndexState]:
        return self._states.get(int(index))

    def indexes(self) -> list[int]:
        return sorted(self._states)


class WriteTxn:
    """A copy-on-write transaction; commit publishes atomically."""

    def __init__(self, db: Database):
        self.db = db
        db._write_lock.acquire()
        self._flock = None
        self._open = False
        try:
            if db.path is not None:
                # cross-process single-writer exclusion (the LMDB writer lock)
                import fcntl
                import os

                os.makedirs(db.path, exist_ok=True)
                self._flock = open(os.path.join(db.path, "LOCK"), "a+")
                fcntl.flock(self._flock.fileno(), fcntl.LOCK_EX)
                db._maybe_reload()
            self._base = dict(db._committed)
            self._states: dict[int, IndexState] = {}
            self._dropped: set[int] = set()
            self._open = True
        except BaseException:
            if self._flock is not None:
                self._flock.close()
            db._write_lock.release()
            raise

    # a WriteTxn is also readable (LMDB RwTxn semantics)
    def state(self, index: int) -> Optional[IndexState]:
        index = int(index)
        if index in self._states:
            return self._states[index]
        if index in self._dropped:
            return None
        return self._base.get(index)

    def state_mut(
        self, index: int, dims: int | None = None, metric=None
    ) -> IndexState:
        index = int(index)
        if not (0 <= index <= MAX_INDEX):
            raise ArroyError(f"index must fit in u16, got {index}")
        st = self._states.get(index)
        if st is not None:
            return st
        st = None if index in self._dropped else self._base.get(index)
        if st is not None:
            st = st.clone()
        else:
            if dims is None or metric is None:
                raise ArroyError(f"index {index} does not exist yet")
            m = resolve_metric(metric)
            st = IndexState(dims=int(dims), metric=m, store=ItemStore(m, dims))
        self._states[index] = st
        self._dropped.discard(index)
        return st

    def drop_index(self, index: int) -> None:
        index = int(index)
        self._states.pop(index, None)
        self._dropped.add(index)

    def indexes(self) -> list[int]:
        live = (set(self._base) - self._dropped) | set(self._states)
        return sorted(live)

    def commit(self) -> None:
        if not self._open:
            raise ArroyError("transaction already closed")
        # every touched state gets a fresh generation so persistence and
        # device caches see the change (the LMDB txn-id role).  The new
        # generation is database-global monotonic — a per-state counter
        # would restart at 1 after drop_index+recreate and collide with
        # the old on-disk generation and device cache, silently serving
        # (and keeping) the dropped index's data.
        gen = 1 + max(
            [st.generation for st in self._base.values()]
            + [st.generation for st in self._states.values()]
            + [0]
        )
        for st in self._states.values():
            st.generation = gen
        self.db._publish(self._states, self._dropped)
        self._close()

    def abort(self) -> None:
        if self._open:
            self._close()

    def _close(self) -> None:
        self._open = False
        if self._flock is not None:
            import fcntl

            fcntl.flock(self._flock.fileno(), fcntl.LOCK_UN)
            self._flock.close()
            self._flock = None
        self.db._write_lock.release()

    # context-manager sugar: commit on clean exit, abort on exception
    def __enter__(self) -> "WriteTxn":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            if self._open:
                self.commit()
        else:
            self.abort()
