"""Writer: item mutation + forest building.

Counterpart of `arroy_tpu/writer.py`.  Public surface mirrors the
reference `Writer`/`ArroyBuilder` (reference: src/writer.rs:37-265):
`add_item(s)`, `append_item`, `del_item(s)`, `clear`, `iter`,
`need_build`, `contains_item`, `item_vector`, and `builder()` with
`n_trees` / `split_after` / `cancel` / `progress`.

`build()` follows the reference's orchestration (reference:
src/writer.rs:487-629) for a build from no roots:

1. distance preprocess (Bachrach pass for dot-product);
2. drain the Updated set;
3. tiny-corpus fast path: one descendants node;
4. tree-count targeting + extra-tree deletion;
5. missing trees, grown by `builder.grow_trees` on the database's device;
6. metadata + version.

Incremental rebuilds (delete-with-collapse and insert routing over
existing trees), memory budgets and multi-device builds are not ported
yet and raise `NotImplementedError` (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from .builder import BuildContext, grow_trees
from .errors import InvalidItemAppend
from .metrics import Metric, resolve_metric
from .models.forest import Forest, NodeIdAllocator
from .progress import CancelFn, MainStep, ProgressFn, SubStep, WriterProgress
from .store.database import Database, IndexState, Metadata, WriteTxn
from .utils.itemset import ItemSet
from .version import CURRENT_VERSION

#: items (lanes) per grow pass: seeds are independent, so large seed
#: lists grow in groups that bound the per-pass frontier state
_GROW_GROUP_ITEMS = 32 << 20

_INCREMENTAL_TODO = (
    "incremental rebuilds (delete-with-collapse, insert routing) are not "
    "ported yet (ROADMAP queue 1: incremental build)"
)


@dataclass
class BuildOptions:
    """Reference `BuildOption` (src/writer.rs:96-114)."""

    n_trees: Optional[int] = None
    split_after: Optional[int] = None
    cancel: CancelFn = lambda: False
    progress: ProgressFn = lambda p: None
    seed: int = 42


class ArroyBuilder:
    """Fluent build-option builder (reference: src/writer.rs:126-265)."""

    def __init__(self, writer: "Writer", seed: int):
        self._writer = writer
        self._opt = BuildOptions(seed=seed)

    def n_trees(self, n: int) -> "ArroyBuilder":
        self._opt.n_trees = int(n)
        return self

    def split_after(self, n: int) -> "ArroyBuilder":
        self._opt.split_after = int(n)
        return self

    def available_memory(self, n_bytes: int) -> "ArroyBuilder":
        raise NotImplementedError(
            "memory-budgeted builds are not ported yet (ROADMAP queue 1: memory budget)"
        )

    def cancel(self, fn: CancelFn) -> "ArroyBuilder":
        self._opt.cancel = fn
        return self

    def progress(self, fn: ProgressFn) -> "ArroyBuilder":
        self._opt.progress = fn
        return self

    def build(self, wtxn: WriteTxn) -> None:
        self._writer._build(wtxn, self._opt)


def target_n_trees(
    n_trees: Optional[int], dimensions: int, item_ids: np.ndarray, roots: list[int]
) -> int:
    """Tree-count formula + shrink hysteresis (reference: src/writer.rs:1358-1394)."""
    if n_trees is not None:
        return int(n_trees)
    nb_vec = float(len(item_ids))
    if nb_vec == 0.0:
        return 1
    if nb_vec < 10_000.0:
        nb_trees = 2.0 ** (math.log2(nb_vec) - 6.0)
    else:
        nb_trees = 2.0 ** (
            math.log10(nb_vec)
            + math.log10(float(dimensions))
            + (768.0 / float(dimensions)) ** 4.0
        )
    nb_trees = int(math.ceil(nb_trees))
    if len(roots) > nb_trees:
        tree_to_remove = len(roots) - nb_trees
        if tree_to_remove / nb_trees < 0.20:
            nb_trees = len(roots)
    return max(nb_trees, 1)


def _swap_remove0(lst: list) -> object:
    """Vec::swap_remove(0) (reference: src/writer.rs:648)."""
    removed = lst[0]
    last = lst.pop()
    if lst:
        lst[0] = last
    return removed


class Writer:
    """Stores and removes items and builds the forest over them."""

    def __init__(self, database: Database, index: int, dimensions: int, metric="euclidean"):
        self.database = database
        self.index = int(index)
        self.dimensions = int(dimensions)
        self.metric: type[Metric] = resolve_metric(metric)

    # -- item mutation (reference: src/writer.rs:380-452) ---------------
    def _state(self, wtxn: WriteTxn) -> IndexState:
        return wtxn.state_mut(self.index, self.dimensions, self.metric)

    def add_item(self, wtxn: WriteTxn, item: int, vector) -> None:
        st = self._state(wtxn)
        st.store.put(item, np.asarray(vector, dtype=np.float32))
        st.updated.add(int(item))

    def add_items(self, wtxn: WriteTxn, items, vectors) -> None:
        """Bulk add — vectorized encode of a whole [n, dims] matrix."""
        st = self._state(wtxn)
        items = np.asarray(items)
        st.store.put_many(items, np.asarray(vectors, dtype=np.float32))
        st.updated.update(int(i) for i in items)

    def append_item(self, wtxn: WriteTxn, item: int, vector) -> None:
        """Fast ordered insert; errors when `item` would not be the last key
        (reference: src/writer.rs:401-421)."""
        st = self._state(wtxn)
        item = int(item)
        if len(st.store) > 0 and item <= st.store.max_id():
            raise InvalidItemAppend()
        for other in wtxn.indexes():
            if other > self.index:
                other_st = wtxn.state(other)
                if other_st is not None and (
                    len(other_st.store) > 0 or other_st.updated
                ):
                    raise InvalidItemAppend()
        st.store.put(item, np.asarray(vector, dtype=np.float32))
        st.updated.add(item)

    def del_item(self, wtxn: WriteTxn, item: int) -> bool:
        st = self._state(wtxn)
        if st.store.delete(item):
            st.updated.add(int(item))
            return True
        return False

    def del_items(self, wtxn: WriteTxn, items) -> int:
        """Bulk delete; returns how many of `items` existed."""
        st = self._state(wtxn)
        n = 0
        for i in np.asarray(items).tolist():
            if st.store.delete(i):
                st.updated.add(int(i))
                n += 1
        return n

    def clear(self, wtxn: WriteTxn) -> None:
        """Remove user items and tree nodes alike (reference: src/writer.rs:439-452)."""
        wtxn.drop_index(self.index)

    # -- introspection -------------------------------------------------
    def need_build(self, rtxn_or_wtxn) -> bool:
        st = rtxn_or_wtxn.state(self.index)
        if st is None:
            return True
        return bool(st.updated) or st.metadata is None

    def contains_item(self, txn, item: int) -> bool:
        st = txn.state(self.index)
        return st is not None and int(item) in st.store

    def item_vector(self, txn, item: int) -> Optional[np.ndarray]:
        st = txn.state(self.index)
        if st is None:
            return None
        return st.store.get_vector(item)

    def is_empty(self, txn) -> bool:
        st = txn.state(self.index)
        return st is None or len(st.store) == 0

    def iter(self, txn) -> Iterator[tuple[int, np.ndarray]]:
        st = txn.state(self.index)
        if st is None:
            return iter(())
        ids = st.store.ids()
        return ((int(i), st.store.get_vector(int(i))) for i in ids)

    def builder(self, seed: int = 42) -> ArroyBuilder:
        return ArroyBuilder(self, seed)

    # ------------------------------------------------------------------
    # the build orchestration
    # ------------------------------------------------------------------
    def _build(self, wtxn: WriteTxn, opt: BuildOptions) -> None:
        from .errors import BuildCancelled

        def cancelled():
            if opt.cancel():
                raise BuildCancelled()

        st = self._state(wtxn)
        metric, dims = st.metric, st.dims
        split_after = opt.split_after if opt.split_after is not None else dims

        # 1. preprocess (reference: src/writer.rs:964-976)
        opt.progress(WriterProgress(MainStep.PRE_PROCESSING_THE_ITEMS))
        cancelled()
        item_ids = st.store.ids()
        if metric.has_extra and len(item_ids):
            slots = st.store.slots_of(item_ids)
            norms, extras = metric.preprocess_np(st.store.rows()[slots])
            st.store.set_preprocess(norms, extras, slots)

        opt.progress(WriterProgress(MainStep.RETRIEVING_THE_ITEMS_IDS))
        cancelled()

        # 2. drain Updated (reference: src/writer.rs:891-914)
        opt.progress(WriterProgress(MainStep.RETRIEVE_THE_UPDATED_ITEMS))
        updated = st.updated

        # 3. tiny-corpus fast path (reference: src/writer.rs:499-501,916-962)
        if len(item_ids) <= split_after:
            st.updated = set()
            opt.progress(WriterProgress(MainStep.WRITING_THE_DESCENDANTS_AND_METADATA))
            forest = Forest()
            roots: list[int] = []
            if len(item_ids):
                forest.put_leaf(0, item_ids)
                roots = [0]
            forest.roots = roots
            forest.repack_normals(
                np.zeros((0, metric.storage_dim(dims)), np.uint32 if metric.binary else np.float32),
                np.zeros(0, np.float32),
            )
            cancelled()
            opt.progress(WriterProgress(MainStep.WRITE_THE_METADATA))
            st.forest = forest
            st.metadata = Metadata(dims, ItemSet.from_sorted(item_ids), roots, metric.name)
            st.version = CURRENT_VERSION
            return

        roots = list(st.metadata.roots) if st.metadata is not None else []
        if roots and updated:
            raise NotImplementedError(_INCREMENTAL_TODO)
        st.updated = set()
        forest = st.forest

        opt.progress(WriterProgress(MainStep.RETRIEVING_THE_USED_TREE_NODES))
        cancelled()
        alloc = NodeIdAllocator(forest.used_node_ids())

        # 4. tree-count targeting (reference: src/writer.rs:521-522,631-653)
        target = target_n_trees(opt.n_trees, dims, item_ids, roots)
        opt.progress(WriterProgress(MainStep.DELETING_EXTRA_TREES))
        for _ in range(max(len(roots) - target, 0)):
            cancelled()
            forest.delete_subtree(_swap_remove0(roots))
        roots.sort()

        # freeze: the device-side context
        opt.progress(WriterProgress(MainStep.RETRIEVING_THE_ITEMS))
        cancelled()
        rows_dev, hnorms_dev, extras_dev = st.store.device_arrays(self.database.device)
        staging, staging_aux, staged_rows = [], [], 0
        if forest.normals is not None and forest.normals.shape[0]:
            staging = [forest.normals]
            staging_aux = [np.asarray(forest.aux, np.float32)]
            staged_rows = int(forest.normals.shape[0])

        sub = SubStep("items", max(len(item_ids), 1))
        ctx = BuildContext(
            metric=metric,
            dims=dims,
            split_after=split_after,
            rows_dev=rows_dev,
            extras_dev=extras_dev,
            hnorms_dev=hnorms_dev,
            slot_to_id=st.store.slot_ids(),
            forest=forest,
            alloc=alloc,
            cancel=opt.cancel,
            staging_normals=staging,
            staging_aux=staging_aux,
            staging_rows=staged_rows,
            on_items_indexed=sub.add,
        )
        gen = torch.Generator(device=self.database.device).manual_seed(int(opt.seed))

        # 5. missing trees (reference: src/writer.rs:545-561)
        opt.progress(WriterProgress(MainStep.RETRIEVE_THE_LARGE_DESCENDANTS))
        all_items = ItemSet.from_sorted(item_ids)
        new_roots = []
        for _ in range(max(target - len(roots), 0)):
            cancelled()
            new_roots.append(alloc.next())
        roots.extend(new_roots)

        # one unit = one item placed into a leaf of one tree
        sub.max = max(len(new_roots) * len(all_items), 1)
        opt.progress(WriterProgress(MainStep.CREATE_TREES_FOR_ITEMS, sub))
        all_slots = st.store.slots_of(all_items.ids)
        seeds = [(nid, all_slots) for nid in new_roots]
        per_group = max(_GROW_GROUP_ITEMS // max(len(all_slots), 1), 1)
        for g in range(0, len(seeds), per_group):
            ctx.check_cancel()
            grow_trees(ctx, seeds[g : g + per_group], gen)

        # 6. metadata + version (reference: src/writer.rs:609-628)
        opt.progress(WriterProgress(MainStep.WRITE_THE_METADATA))
        forest.roots = roots
        forest.repack_normals(ctx.staging_matrix_np(), ctx.staging_aux_np())
        st.metadata = Metadata(dims, all_items, list(roots), metric.name)
        st.version = CURRENT_VERSION
