"""Item (leaf-vector) storage.

The reference stores each item as an LMDB `Leaf{header, vector}` record
keyed by `(index, Item, item_id)` (reference: src/node.rs:26-43,
src/key.rs:19-51).  Here the items of one index live in a single host
matrix of storage rows (f32 or packed bits) indexed by *slot*, with an
id→slot map; the device mirror of the matrix is what every hot kernel
reads.  Item ids are arbitrary u32s exactly like the reference (sparse,
up to u32::MAX) — memory scales with the number of items, not the max id
(reference README.md:39).
"""

from __future__ import annotations

import itertools
import os
from collections import OrderedDict

import numpy as np

from ..errors import InvalidVecDimension
from ..metrics import Metric

#: globally-unique mutation stamps: no two distinct store states within a
#: lineage can ever share an epoch, so MVCC clones that diverge from the
#: same base invalidate each other's device mirror instead of corrupting it
_EPOCHS = itertools.count(1)

#: lineage -> (sync_epoch, rows_dev, norms_dev, extras_dev).  One resident
#: device mirror per store lineage (clones share the lineage; the epoch
#: check decides whether the mirror can be reused or must be re-uploaded).
#: Bounded LRU so dropped/forgotten indexes release their device memory.
_DEVICE_MIRROR: "OrderedDict[int, tuple]" = OrderedDict()
_DEVICE_MIRROR_CAP = 4

#: rows the last `ItemStore.device_arrays` call sent to the device (0 when
#: the mirror was current; the capacity on a full upload)
mirror_rows_uploaded = 0


class ItemStore:
    """Mutable id→vector storage for one index."""

    def __init__(self, metric: type[Metric], dims: int):
        self.metric = metric
        self.dims = int(dims)
        sd = metric.storage_dim(dims)
        np_dtype = np.uint32 if metric.binary else np.float32
        self._rows = np.zeros((0, sd), dtype=np_dtype)
        self._norms = np.zeros((0,), dtype=np.float32)
        self._extras = np.zeros((0,), dtype=np.float32)
        self._slot_ids = np.zeros((0,), dtype=np.int64)  # slot -> id (-1 = free)
        self._id_to_slot: dict[int, int] = {}
        self._free: list[int] = []
        self._lineage = next(_EPOCHS)
        self._epoch = 0  # last mutation stamp
        self._sync_epoch = -1  # epoch at the last device-mirror sync
        self._dirty: set[int] = set()  # slots touched since that sync

    @staticmethod
    def from_arrays(
        metric: type[Metric],
        dims: int,
        rows: np.ndarray,
        norms: np.ndarray,
        extras: np.ndarray,
        slot_ids: np.ndarray,
    ) -> "ItemStore":
        """Rebuild a store from persisted arrays (see store/persist.py)."""
        s = ItemStore(metric, dims)
        s._rows = np.ascontiguousarray(rows)
        s._norms = np.ascontiguousarray(norms, dtype=np.float32)
        s._extras = np.ascontiguousarray(extras, dtype=np.float32)
        s._slot_ids = np.ascontiguousarray(slot_ids, dtype=np.int64)
        s._id_to_slot = {
            int(i): int(slot) for slot, i in enumerate(s._slot_ids) if i >= 0
        }
        s._free = [int(x) for x in np.nonzero(s._slot_ids < 0)[0][::-1]]
        return s

    # -- copy-on-write ------------------------------------------------
    def clone(self) -> "ItemStore":
        c = ItemStore.__new__(ItemStore)
        c.metric = self.metric
        c.dims = self.dims
        c._rows = self._rows.copy()
        c._norms = self._norms.copy()
        c._extras = self._extras.copy()
        c._slot_ids = self._slot_ids.copy()
        c._id_to_slot = dict(self._id_to_slot)
        c._free = list(self._free)
        c._lineage = self._lineage
        c._epoch = self._epoch
        c._sync_epoch = self._sync_epoch
        c._dirty = set(self._dirty)
        return c

    def _touch(self, slots) -> None:
        self._epoch = next(_EPOCHS)
        self._dirty.update(slots)

    def device_arrays(self, device):
        """Device mirror of (rows, norms, extras) on `device`, synced
        incrementally.

        The mirror persists across builds and readers of one store
        lineage.  When the cached copy matches this store's last sync,
        only the slots mutated since then go to the device: one host
        gather of the dirty rows, scattered with ``index_copy_``, so an
        incremental build after touching N items uploads N rows.  Growth
        in capacity pads the mirror with zeros on the device.  Any
        divergence (an aborted txn, a competing clone, another device, a
        smaller capacity), or a quarter of the slots dirty, uploads the
        whole matrix.  The patch writes into a copy made on the device:
        readers of older snapshots hold the previous tensors (a
        `DeviceIndex` serves from them), and they must not change.  BQ
        rows go to the device as int32 bit patterns.
        `mirror_rows_uploaded` counts the rows this call sent.
        ``ARROY_DEVICE_MIRROR=0`` disables reuse: every call uploads the
        whole matrix, as the JAX package's switch does.
        """
        import torch

        global mirror_rows_uploaded
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # tensors report "cuda:N": compare the mirror's device with that
            device = torch.device("cuda", torch.cuda.current_device())
        cap = self._rows.shape[0]
        ent = (
            _DEVICE_MIRROR.get(self._lineage)
            if os.environ.get("ARROY_DEVICE_MIRROR", "1") != "0"
            else None
        )
        patchable = (
            ent is not None
            and ent[0] == self._sync_epoch
            and ent[1].device == device
            and ent[1].shape[0] <= cap
            and ent[1].shape[1] == self._rows.shape[1]
        )
        idx = np.fromiter(self._dirty, np.int64, len(self._dirty))
        if not patchable or len(idx) * 4 >= cap:
            rows, norms, extras = self._upload_all(device)
            mirror_rows_uploaded = cap
        else:
            rows, norms, extras = self._patch(ent[1:], np.sort(idx), device)
            mirror_rows_uploaded = len(idx)
        if self._epoch == 0:
            self._epoch = next(_EPOCHS)
        self._sync_epoch = self._epoch
        self._dirty.clear()
        _DEVICE_MIRROR[self._lineage] = (self._sync_epoch, rows, norms, extras)
        _DEVICE_MIRROR.move_to_end(self._lineage)
        while len(_DEVICE_MIRROR) > _DEVICE_MIRROR_CAP:
            _DEVICE_MIRROR.popitem(last=False)
        return rows, norms, extras

    def _host_rows(self) -> np.ndarray:
        return self._rows.view(np.int32) if self.metric.binary else self._rows

    def _upload_all(self, device):
        """The whole matrix, norms and extras on `device` (copy=True: on the
        CPU the mirror must not alias the store)."""
        import torch

        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)
            for a in (self._host_rows(), self._norms, self._extras)
        )

    def _patch(self, mirror, idx: np.ndarray, device):
        """`mirror` (rows, norms, extras) grown to this capacity with zeros
        and with the sorted slots `idx` replaced by the store's."""
        import torch

        cap = self._rows.shape[0]
        out = []
        for t, host in zip(mirror, (self._host_rows(), self._norms, self._extras)):
            pad = cap - t.shape[0]
            if pad:
                t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
            elif len(idx):
                t = t.clone()
            if len(idx):
                t.index_copy_(
                    0,
                    torch.from_numpy(idx).to(device),
                    torch.from_numpy(np.ascontiguousarray(host[idx])).to(device),
                )
            out.append(t)
        return tuple(out)

    # -- basic ops -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._id_to_slot)

    def __contains__(self, item: int) -> bool:
        return int(item) in self._id_to_slot

    def ids(self) -> np.ndarray:
        """Sorted array of live item ids."""
        if not self._id_to_slot:
            return np.empty(0, dtype=np.uint32)
        return np.sort(np.fromiter(self._id_to_slot, dtype=np.int64)).astype(np.uint32)

    def max_id(self) -> int:
        return max(self._id_to_slot) if self._id_to_slot else -1

    def _grow(self, extra: int) -> None:
        n = self._rows.shape[0]
        new = max(extra, n // 2, 64)
        self._rows = np.concatenate(
            [self._rows, np.zeros((new, self._rows.shape[1]), self._rows.dtype)]
        )
        self._norms = np.concatenate([self._norms, np.zeros(new, np.float32)])
        self._extras = np.concatenate([self._extras, np.zeros(new, np.float32)])
        self._slot_ids = np.concatenate([self._slot_ids, np.full(new, -1, np.int64)])
        self._free.extend(range(n + new - 1, n - 1, -1))

    def put(self, item: int, vector: np.ndarray) -> None:
        vector = np.asarray(vector, dtype=np.float32)
        if vector.shape != (self.dims,):
            raise InvalidVecDimension(self.dims, int(np.prod(vector.shape)))
        item = int(item)
        if not (0 <= item <= 0xFFFFFFFF):
            # item ids are u32 like the reference's ItemId; a negative id
            # would collide with the -1 free-slot sentinel
            raise ValueError(f"item id must be a u32, got {item}")
        slot = self._id_to_slot.get(item)
        if slot is None:
            if not self._free:
                self._grow(1)
            slot = self._free.pop()
            self._id_to_slot[item] = slot
            self._slot_ids[slot] = item
        row = self.metric.encode_np(vector[None, :])[0]
        self._rows[slot] = row
        self._norms[slot] = self.metric.item_norms_np(row[None, :], self.dims)[0]
        self._extras[slot] = 0.0
        self._touch((slot,))

    def put_many(self, items: np.ndarray, vectors: np.ndarray) -> None:
        """Vectorized bulk insert/overwrite (no reference equivalent —
        the vectorized ingestion path; add_item loops are Python-bound)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        items = np.asarray(items, dtype=np.int64)
        if vectors.ndim != 2 or vectors.shape[1] != self.dims:
            raise InvalidVecDimension(self.dims, int(vectors.shape[-1]))
        if len(items) != len(vectors):
            raise ValueError("items and vectors length mismatch")
        if len(items) and (items.min() < 0 or items.max() > 0xFFFFFFFF):
            raise ValueError("item ids must be u32s")
        rows = self.metric.encode_np(vectors)
        norms = self.metric.item_norms_np(rows, self.dims)
        slots = np.empty(len(items), np.int64)
        for j, item in enumerate(items):
            item = int(item)
            slot = self._id_to_slot.get(item)
            if slot is None:
                if not self._free:
                    self._grow(len(items) - j)
                slot = self._free.pop()
                self._id_to_slot[item] = slot
                self._slot_ids[slot] = item
            slots[j] = slot
        # content-aware dirty marking: only slots whose stored bytes
        # actually change invalidate the device mirror, so idempotent
        # re-upserts (a common ingestion pattern — and the warm-rebuild
        # benchmark) don't re-pay the host->device transfer of the whole
        # matrix.  Duplicate ids resolve last-wins, matching fancy-assign.
        uniq, pos = np.unique(slots[::-1], return_index=True)
        pos = len(slots) - 1 - pos
        changed = (
            np.any(self._rows[uniq] != rows[pos], axis=1)
            | (self._norms[uniq] != norms[pos])
            | (self._extras[uniq] != 0.0)
        )
        self._rows[slots] = rows
        self._norms[slots] = norms
        self._extras[slots] = 0.0
        if np.any(changed):
            self._touch(uniq[changed].tolist())

    def delete(self, item: int) -> bool:
        slot = self._id_to_slot.pop(int(item), None)
        if slot is None:
            return False
        self._slot_ids[slot] = -1
        self._rows[slot] = 0
        self._norms[slot] = 0.0
        self._extras[slot] = 0.0
        self._free.append(slot)
        self._touch((slot,))
        return True

    def get_vector(self, item: int) -> np.ndarray | None:
        """Decoded vector as the user would read it back (`item_vector`).

        For binary-quantized metrics this returns ±1.0 per dimension,
        exactly like the reference decode (src/unaligned_vector/
        binary_quantized.rs:160-219, truncated to `dims`).
        """
        slot = self._id_to_slot.get(int(item))
        if slot is None:
            return None
        return self.metric.decode_np(self._rows[slot][None, :], self.dims)[0]

    # -- bulk views for the build/search engines ------------------------
    def slots_of(self, items: np.ndarray) -> np.ndarray:
        """Map an array of (live) item ids to their slots."""
        return np.fromiter(
            (self._id_to_slot[int(i)] for i in items), dtype=np.int32, count=len(items)
        )

    def rows(self) -> np.ndarray:
        return self._rows

    def norms(self) -> np.ndarray:
        return self._norms

    def extras(self) -> np.ndarray:
        return self._extras

    def slot_ids(self) -> np.ndarray:
        return self._slot_ids

    def capacity(self) -> int:
        return self._rows.shape[0]

    def set_preprocess(self, norms: np.ndarray, extras: np.ndarray, slots: np.ndarray) -> None:
        """Write per-item header data computed by `Distance::preprocess`."""
        self._norms[slots] = norms
        self._extras[slots] = extras
        self._touch(np.asarray(slots).tolist())
