"""Device mirror of one committed index generation.

Counterpart of `arroy_tpu/device.py`.  Packs the host `ItemStore` +
`Forest` into flat tensors on one device for the query engine: node
table, CSR leaf membership, the normals matrix and the item matrix.
Built lazily and cached per generation by the Database; immutable once
created.

`build_np` is the JAX package's host-side pack, copied verbatim, and
`from_numpy` turns that dict into tensors on a device — so an
`arroy_tpu.device.DeviceIndex.build_np(...)` pack feeds the port
directly and both packages search the identical state.  Packed BQ words
go to the device as int32 bit patterns; `slot_to_id` becomes int64.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .metrics import Metric
from .models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE, Forest
from .models.items import ItemStore
from .utils import profiling

#: pack entries that become device tensors (the rest stay host values)
_TENSOR_KEYS = (
    "rows", "norms", "extras", "slot_to_id", "live", "kind", "node_table",
    "left", "right", "ptr", "normals", "aux", "leaf_off", "leaf_cnt",
    "leaf_items",
)


def _to_device(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        # packed sign-bit words: keep the bit pattern
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device)


def leaf_pops_bound(leaf_cum, search_k: int) -> int:
    """Worst-case non-empty leaf pops before ``search_k`` candidate slots
    are filled, from the ascending cumulative sum of a forest's leaf sizes:
    take the smallest leaves first (``search_k`` itself without one)."""
    if leaf_cum is None or len(leaf_cum) == 0:
        return max(search_k, 1)
    m = int(np.searchsorted(leaf_cum, search_k, side="left")) + 1
    return min(m, len(leaf_cum))


@dataclass(frozen=True)
class DeviceIndex:
    metric: type[Metric]
    dims: int
    device: torch.device
    # items
    rows: torch.Tensor  # [cap, sd] f32 (bf16 under ARROY_SERVING_DTYPE=bf16),
    # or int32 bit patterns for BQ
    norms: torch.Tensor  # [cap] f32
    extras: torch.Tensor  # [cap] f32
    slot_to_id: torch.Tensor  # [cap] int64 (0xFFFFFFFF where not live; use
    # `live` to distinguish — u32::MAX is a legal item id)
    live: torch.Tensor  # [cap] bool
    slot_to_id_np: np.ndarray  # [cap] int64, -1 free
    # forest node table
    kind: torch.Tensor  # [Np] int32
    left: torch.Tensor
    right: torch.Tensor
    ptr: torch.Tensor
    #: packed per-node row [Np, 8]: kind,left,right,ptr,leaf_off,leaf_cnt,0,0
    node_table: torch.Tensor
    normals: torch.Tensor  # [S, sd]
    aux: torch.Tensor  # [S]
    leaf_off: torch.Tensor  # [L] int32 into leaf_items
    leaf_cnt: torch.Tensor  # [L]
    leaf_items: torch.Tensor  # [total + W] int32 slots, -1 padded
    roots: tuple[int, ...]
    n_nodes: int
    n_items: int
    max_leaf: int
    cap: int
    #: ascending-sorted leaf sizes, cumulative (host) — bounds the number
    #: of leaf pops any query can need to reach a candidate budget
    leaf_cum_np: np.ndarray = None
    #: number of split nodes — bounds queue pushes (each split node enters
    #: the priority queue at most once: one parent, popped once)
    n_splits: int = 0
    #: table rows poppable without yielding candidates (empty leaves, FREE)
    n_dead_pops: int = 0

    def max_leaf_pops(self, search_k: int) -> int:
        """Worst-case non-empty leaf pops before `search_k` candidate
        slots are filled (`leaf_pops_bound`)."""
        return leaf_pops_bound(self.leaf_cum_np, search_k)

    def nbytes(self) -> int:
        """Device bytes of this index's tensors (the budget a serving
        deployment reserves per resident generation), bf16 rows at 2 bytes
        a value.  `slot_to_id` is int64 here, so this is 4 bytes a slot
        more than the JAX package's uint32 count."""
        return sum(
            f.numel() * f.element_size()
            for f in (
                self.rows, self.norms, self.extras, self.slot_to_id, self.live,
                self.kind, self.left, self.right, self.ptr, self.node_table,
                self.normals, self.aux, self.leaf_off, self.leaf_cnt,
                self.leaf_items,
            )
        )

    @staticmethod
    def estimate_nbytes(metric: type[Metric], dims: int, n_items: int, n_trees: int) -> int:
        """Pre-build estimate: item matrix + ~2 nodes per `dims`-sized
        leaf per tree (split_after = dims, reference src/writer.rs:474-477)."""
        sd = metric.storage_dim(dims)
        itemsize = 4
        items = n_items * (sd + 4) * itemsize  # rows + norm/extra/id/live
        n_leaves = max(-(-n_items // max(dims // 2, 1)), 1)  # half-full leaves
        nodes = 2 * n_leaves * n_trees
        forest = nodes * (12 * itemsize) + n_leaves * n_trees * 2 * itemsize
        forest += (nodes // 2) * sd * itemsize  # split normals
        forest += n_items * n_trees * itemsize  # CSR membership per tree
        return items + forest

    @staticmethod
    def build_np(metric: type[Metric], dims: int, store: ItemStore, forest: Forest) -> dict:
        """Host-side pack of all index arrays (used by build() and by the
        sharded index, which stacks several packs before upload)."""
        cap = max(store.capacity(), 1)
        sd = metric.storage_dim(dims)
        np_dtype = np.uint32 if metric.binary else np.float32
        rows = np.zeros((cap, sd), dtype=np_dtype)
        rows[: store.capacity()] = store.rows()
        norms = np.zeros(cap, np.float32)
        norms[: store.capacity()] = store.norms()
        extras = np.zeros(cap, np.float32)
        extras[: store.capacity()] = store.extras()
        s2i = np.full(cap, -1, np.int64)
        s2i[: store.capacity()] = store.slot_ids()

        # id -> slot lookup for converting leaf id-sets to slots
        live = np.nonzero(s2i >= 0)[0]
        live_ids = s2i[live]
        order = np.argsort(live_ids)
        sorted_ids = live_ids[order]
        sorted_slots = live[order].astype(np.int32)

        n_table = max(int(forest.kind.shape[0]), 1)
        kind = np.full(n_table, KIND_FREE, np.int32)
        kind[: forest.kind.shape[0]] = forest.kind
        left = np.zeros(n_table, np.int32)
        left[: forest.left.shape[0]] = forest.left
        right = np.zeros(n_table, np.int32)
        right[: forest.right.shape[0]] = forest.right
        ptr = np.zeros(n_table, np.int32)
        ptr[: forest.ptr.shape[0]] = forest.ptr

        # CSR leaves
        leaf_nodes = sorted(forest.leaves)
        offs, cnts, chunks = [], [], []
        off = 0
        max_leaf = 1
        for li, nid in enumerate(leaf_nodes):
            ids = forest.leaves[nid]
            pos = np.searchsorted(sorted_ids, ids.astype(np.int64))
            slots = sorted_slots[np.minimum(pos, max(len(sorted_ids) - 1, 0))] if len(sorted_ids) else np.empty(0, np.int32)
            offs.append(off)
            cnts.append(len(ids))
            chunks.append(slots.astype(np.int32))
            ptr[nid] = li
            off += len(ids)
            max_leaf = max(max_leaf, len(ids))
        flat = (
            np.concatenate(chunks) if chunks else np.empty(0, np.int32)
        )
        flat = np.concatenate([flat, np.full(max_leaf, -1, np.int32)])

        normals = forest.normals
        aux = forest.aux
        if normals is None or normals.shape[0] == 0:
            normals = np.zeros((1, sd), dtype=np_dtype)
            aux = np.zeros(1, np.float32)

        offs_arr = np.asarray(offs, np.int32) if offs else np.zeros(1, np.int32)
        cnts_arr = np.asarray(cnts, np.int32) if cnts else np.zeros(1, np.int32)
        node_table = np.zeros((n_table, 8), np.int32)
        node_table[:, 0] = kind
        node_table[:, 1] = left
        node_table[:, 2] = right
        node_table[:, 3] = ptr
        is_leaf_node = kind == KIND_LEAF
        li = np.clip(ptr, 0, len(offs_arr) - 1)
        node_table[:, 4] = np.where(is_leaf_node, offs_arr[li], 0)
        node_table[:, 5] = np.where(is_leaf_node, cnts_arr[li], 0)

        nonzero_cnts = cnts_arr[cnts_arr > 0]
        leaf_cum = np.cumsum(np.sort(nonzero_cnts)).astype(np.int64)
        n_splits = int(np.count_nonzero((kind == KIND_SPLIT) | (kind == KIND_SPLIT_NONE)))
        # rows a traversal could pop without yielding candidates: empty
        # leaves, FREE rows (defensively drained as no-ops)
        n_dead_pops = int(n_table - n_splits - len(nonzero_cnts))

        return dict(
            leaf_cum_np=leaf_cum,
            n_splits=n_splits,
            n_dead_pops=n_dead_pops,
            rows=rows,
            norms=norms,
            extras=extras,
            slot_to_id=np.where(s2i >= 0, s2i, 0xFFFFFFFF).astype(np.uint32),
            live=s2i >= 0,
            slot_to_id_np=s2i,
            kind=kind,
            node_table=node_table,
            left=left,
            right=right,
            ptr=ptr,
            normals=normals,
            aux=aux,
            leaf_off=offs_arr,
            leaf_cnt=cnts_arr,
            leaf_items=flat,
            roots=tuple(int(r) for r in forest.roots),
            n_nodes=forest.n_nodes(),
            n_items=len(store),
            max_leaf=max_leaf,
            cap=cap,
        )

    @staticmethod
    def from_numpy(pack: dict, metric: type[Metric], dims: int, device) -> "DeviceIndex":
        """Tensors on `device` from a `build_np` pack (either package's).

        Pack entries may already be tensors (the store's device mirror)."""
        device = torch.device(device)
        t = {k: _to_device(pack[k], device) for k in _TENSOR_KEYS if k != "slot_to_id"}
        t["slot_to_id"] = torch.from_numpy(
            np.asarray(pack["slot_to_id"], np.int64)
        ).to(device)
        return DeviceIndex(
            metric=metric,
            dims=dims,
            device=device,
            slot_to_id_np=pack["slot_to_id_np"],
            roots=tuple(pack["roots"]),
            n_nodes=pack["n_nodes"],
            n_items=pack["n_items"],
            max_leaf=pack["max_leaf"],
            cap=pack["cap"],
            leaf_cum_np=pack["leaf_cum_np"],
            n_splits=pack["n_splits"],
            n_dead_pops=pack["n_dead_pops"],
            **t,
        )

    @staticmethod
    @profiling.spanned("arroy.bind.device_index")
    def build(
        metric: type[Metric], dims: int, store: ItemStore, forest: Forest, device
    ) -> "DeviceIndex":
        pk = DeviceIndex.build_np(metric, dims, store, forest)
        if os.environ.get("ARROY_SERVING_DTYPE", "").lower() == "bf16" and not metric.binary:
            # the item matrix lives on the device in bf16 (half the bytes),
            # cast from the host pack with round-to-nearest-even, the JAX
            # package's bits; norms and extras stay f32
            pk["rows"] = torch.from_numpy(pk["rows"]).to(torch.bfloat16)
        elif store.capacity() > 0:
            # reuse the store's resident mirror (identical content; build_np
            # only zero-pads an empty store)
            pk["rows"], pk["norms"], pk["extras"] = store.device_arrays(device)
        return DeviceIndex.from_numpy(pk, metric, dims, device)
