"""Writer: item mutation + forest building.

Counterpart of `arroy_tpu/writer.py`.  Public surface mirrors the
reference `Writer`/`ArroyBuilder` (reference: src/writer.rs:37-265):
`add_item(s)`, `append_item`, `del_item(s)`, `clear`, `iter`,
`need_build`, `contains_item`, `item_vector`, and `builder()` with
`n_trees` / `split_after` / `available_memory` / `cancel` / `progress`.

`build()` follows the reference's orchestration step for step
(reference: src/writer.rs:487-629):

1. distance preprocess (Bachrach pass for dot-product);
2. drain the Updated set → (to_delete, to_insert);
3. tiny-corpus fast path: one descendants node;
4. tree-count targeting + extra-tree deletion;
5. delete removed items from every tree, with branch collapse
   (src/writer.rs:1021-1114);
6. route inserted items down the frozen trees on the database's device
   (`builder.route_lanes`, src/writer.rs:1398-1459);
7. grow every oversized descendant and every missing tree
   (`builder.grow_trees`), within the memory budget when one is given;
8. metadata + version.

Every random draw of steps 6 and 7 comes from the JAX package's threefry
keys (`prng`), derived from the seed as its writer derives them, so a
seed builds the JAX package's forest on any device.
`ArroyBuilder.mesh` grows step 7 with the per-level compute sharded over
a `parallel.mesh.Mesh` (`parallel.build.grow_trees_sharded`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from . import prng
from .builder import BuildContext, grow_streams, grow_trees, route_items, route_lanes
from .errors import InvalidItemAppend
from .metrics import Metric, resolve_metric
from .models import items as items_mod
from .models.forest import KIND_LEAF, Forest, NodeIdAllocator
from .progress import CancelFn, MainStep, ProgressFn, SubStep, WriterProgress
from .store.database import Database, IndexState, Metadata, WriteTxn
from .utils import profiling
from .utils.itemset import ItemSet
from .version import CURRENT_VERSION

#: caps on one grow pass without a memory budget: seeds are independent,
#: so a long seed list grows in groups that bound the per-pass frontier
#: state (split segments, lanes, lanes x storage width)
_GROW_GROUP_SPLITS = 262_144
_GROW_GROUP_ITEMS = 32 << 20
_GROW_GROUP_LANE_DIM = 1 << 34
#: budget mode: sampled-skeleton regrowths of one node before it is written
#: as an oversized leaf
_MAX_REGROW = 8

#: what the last build did: streaming, budget_items, mirror_rows (rows the
#: device mirror uploaded), deleted / inserted (ids in the Updated set and
#: of those still live), routed_lanes, seeds / seed_items (subtrees grown
#: and their items), valve_items (items left in oversized leaves)
build_stats: dict = {}


@dataclass
class BuildOptions:
    """Reference `BuildOption` (src/writer.rs:96-114)."""

    n_trees: Optional[int] = None
    split_after: Optional[int] = None
    available_memory: Optional[int] = None
    cancel: CancelFn = lambda: False
    progress: ProgressFn = lambda p: None
    seed: int = 42
    #: a `parallel.mesh.Mesh`: grow the forest with the per-level compute
    #: sharded over it (`parallel.build`), the multi-device counterpart of
    #: the reference's rayon pool (src/writer.rs:568-591).  Ignored when
    #: `available_memory` makes the build stream.
    mesh: object = None


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
        """Build within about `n_bytes` of device memory for the items: past
        `n_bytes // (4 + 4 * storage dim)` items the matrix stays on the
        host and trees grow from sampled batches."""
        self._opt.available_memory = int(n_bytes)
        return self

    def cancel(self, fn: CancelFn) -> "ArroyBuilder":
        self._opt.cancel = fn
        return self

    def mesh(self, mesh) -> "ArroyBuilder":
        """Build over a `parallel.mesh.Mesh`: one forest, compute sharded."""
        self._opt.mesh = mesh
        return self

    def progress(self, fn: ProgressFn) -> "ArroyBuilder":
        self._opt.progress = fn
        return self

    def build(self, wtxn: WriteTxn) -> None:
        """Build the forest; the span ``arroy.build`` holds one child span
        a main step reported to `progress`, from its report to the next."""
        opt = self._opt
        with profiling.span("arroy.build"), contextlib.ExitStack() as step:
            def progress(p: WriterProgress) -> None:
                step.close()
                step.enter_context(profiling.span("arroy.build." + p.main.name.lower()))
                opt.progress(p)

            self._writer._build(wtxn, dataclasses.replace(opt, progress=progress))


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


def _leaves_losing(forest: Forest, to_delete: ItemSet) -> dict[int, np.ndarray]:
    """leaf → mask of its ids in `to_delete`, for the leaves that lose any:
    one sorted membership test over every leaf's ids at once (a set
    difference a leaf would re-sort `to_delete` each time, O(M x leaves)
    for a mass delete)."""
    nids = list(forest.leaves)
    arrays = [forest.leaves[n] for n in nids]
    if not arrays:
        return {}
    hit = to_delete.contains_many(np.concatenate(arrays))
    lens = np.fromiter(map(len, arrays), np.int64, len(arrays))
    ends = np.cumsum(lens)
    starts = ends - lens
    csum = np.concatenate([[0], np.cumsum(hit)])
    return {
        nids[i]: hit[starts[i] : ends[i]]
        for i in np.nonzero(csum[ends] - csum[starts])[0].tolist()
    }


def _merge_routed(
    forest: Forest, dest: np.ndarray, ids: np.ndarray, batch: np.ndarray
) -> dict[int, np.ndarray]:
    """Each leaf in `dest` → its old ids united with the `ids` routed to it
    (sorted, unique), in the JAX package's order: by the first routing
    `batch` that reached the leaf, then ascending (it fills its dict batch
    after batch, and that order is the seeds' order in the grow).  Keys
    are leaf rank << 32 | id: the old leaves' keys are one sorted run
    already, so a stable sort of the two runs is a merge, and one pass
    drops the duplicates."""
    nids = np.unique(dest)
    empty = np.empty(0, np.uint32)
    old = [forest.leaves.get(n, empty) for n in nids.tolist()]
    lens = np.fromiter(map(len, old), np.int64, len(old))
    rank = np.arange(len(nids), dtype=np.int64) << 32
    old_keys = np.repeat(rank, lens) | np.concatenate([empty, *old]).astype(np.int64)
    new_keys = np.sort(rank[np.searchsorted(nids, dest)] | ids.astype(np.int64))
    keys = np.sort(np.concatenate([old_keys, new_keys]), kind="stable")
    keys = keys[np.concatenate([[True], keys[1:] != keys[:-1]])]
    bounds = np.searchsorted(keys, np.append(rank, len(nids) << 32)).tolist()
    ids = (keys & 0xFFFFFFFF).astype(np.uint32)
    first = np.full(len(nids), len(dest), np.int64)
    np.minimum.at(first, np.searchsorted(nids, dest), batch)
    order = np.argsort(first, kind="stable").tolist()
    return {int(nids[i]): ids[bounds[i] : bounds[i + 1]] for i in order}


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
        with profiling.span("arroy.add_items"):
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

    def prepare_changing_distance(self, wtxn: WriteTxn, new_metric) -> "Writer":
        """Clear the tree nodes and re-encode the items for a new distance;
        returns the writer to build with (reference: src/writer.rs:288-319)."""
        new_metric = resolve_metric(new_metric)
        if new_metric is not self.metric:
            st = wtxn.state(self.index)
            if st is not None:
                st = wtxn.state_mut(self.index)
                ids = st.store.ids()
                vectors = st.metric.decode_np(st.store.rows()[st.store.slots_of(ids)], st.dims)
                st.metric = new_metric
                st.store = items_mod.ItemStore(new_metric, self.dimensions)
                st.store.put_many(ids, vectors)
                st.forest = Forest()
                st.metadata = None
        return Writer(self.database, self.index, self.dimensions, new_metric)

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
        build_stats.clear()

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
        updated = ItemSet(np.fromiter(st.updated, dtype=np.int64, count=len(st.updated)))
        st.updated = set()

        # 3. tiny-corpus fast path (reference: src/writer.rs:499-501,916-962)
        if len(item_ids) <= split_after:
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

        to_delete = updated
        to_insert = ItemSet.from_sorted(item_ids).intersection(updated)
        roots = list(st.metadata.roots) if st.metadata is not None else []
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

        # 5. delete removed items from every tree (reference: src/writer.rs:978-1114)
        opt.progress(WriterProgress(MainStep.REMOVE_ITEMS_FROM_EXISTING_TREES))
        if len(to_delete):
            losing = _leaves_losing(forest, to_delete)
            roots = [
                self._delete_items_in_tree(forest, r, losing, split_after, cancelled)
                for r in roots
            ]
        roots.sort()

        # freeze: the device-side context
        opt.progress(WriterProgress(MainStep.RETRIEVING_THE_ITEMS))
        cancelled()
        budget_items = None
        if opt.available_memory is not None:
            item_bytes = 4 + 4 * metric.storage_dim(dims)
            budget_items = max(opt.available_memory // item_bytes, dims + 1)
        # streaming mode: the item matrix stays on the host and each grow
        # or routing call uploads the rows it needs (the reference's
        # fit_in_memory); resident mode syncs the store's device mirror,
        # which uploads only the slots changed since its last sync.  Mesh
        # mode keeps the host mirror too: the sharded grow uploads each
        # shard's rows to its own device
        mesh_mode = opt.mesh is not None and budget_items is None
        streaming = (budget_items is not None and budget_items < len(item_ids)) or mesh_mode
        if streaming:
            rows_dev = hnorms_dev = extras_dev = None
        else:
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
            device=self.database.device,
            rows_dev=rows_dev,
            extras_dev=extras_dev,
            hnorms_dev=hnorms_dev,
            slot_to_id=st.store.slot_ids(),
            forest=forest,
            alloc=alloc,
            cancel=opt.cancel,
            budget_items=budget_items,
            rows_np=st.store.rows() if streaming else None,
            extras_np=st.store.extras() if streaming else None,
            hnorms_np=st.store.norms() if streaming else None,
            staging_normals=staging,
            staging_aux=staging_aux,
            staging_rows=staged_rows,
            on_items_indexed=sub.add,
        )
        key = prng.key(opt.seed)

        # 6. route inserted items down the frozen trees, in budget-sized
        #    batches (reference: src/writer.rs:846-888,1119-1159)
        opt.progress(WriterProgress(MainStep.INSERT_ITEMS_IN_CURRENT_TREES))
        descendants: dict[int, np.ndarray] = {}  # node → sorted unique ids
        routed_lanes = 0
        if len(to_insert) and roots:
            insert_slots = ctx.ids_to_slots(to_insert.ids)
            normals = ctx.staging_matrix_dev()
            aux_lookup = ctx.staging_aux_np()
            chunk = max(budget_items or len(insert_slots), 1)
            dests, slots, batch_of = [], [], []
            for b, off in enumerate(range(0, len(insert_slots), chunk)):
                cancelled()
                part = insert_slots[off : off + chunk]
                d, s = route_lanes(
                    ctx, normals, aux_lookup, [(r, part) for r in roots],
                    prng.fold_in(key, 0x0F0F + off),
                )
                dests.append(d)
                slots.append(s)
                batch_of.append(np.full(len(d), b, np.int64))
            routed_lanes = int(sum(len(d) for d in dests))
            descendants = _merge_routed(
                forest, np.concatenate(dests), ctx.slot_to_id[np.concatenate(slots)],
                np.concatenate(batch_of),
            )

        # 7. missing trees (reference: src/writer.rs:545-561)
        opt.progress(WriterProgress(MainStep.RETRIEVE_THE_LARGE_DESCENDANTS))
        all_items = ItemSet.from_sorted(item_ids)
        for _ in range(max(target - len(roots), 0)):
            cancelled()
            new_id = alloc.next()
            roots.append(new_id)
            descendants[new_id] = all_items.ids

        # one unit = one item placed into a leaf of one tree
        sub.max = max(sum(len(items) for items in descendants.values()), 1)
        opt.progress(WriterProgress(MainStep.CREATE_TREES_FOR_ITEMS, sub))
        seeds: list[tuple[int, np.ndarray]] = []
        fits = [(nid, ids) for nid, ids in descendants.items() if len(ids) <= split_after]
        if fits:
            forest.put_leaves(np.array([nid for nid, _ in fits]), [ids for _, ids in fits])
            sub.add(sum(len(ids) for _, ids in fits))
        for nid, ids in descendants.items():
            if len(ids) > split_after:
                cancelled()
                seeds.append((nid, ctx.ids_to_slots(ids)))
        if mesh_mode:
            from .parallel.build import grow_trees_sharded

            grow_trees_sharded(ctx, seeds, prng.fold_in(key, 0xB111D), opt.mesh)
        else:
            self._grow_with_budget(ctx, seeds, prng.fold_in(key, 0xB111D))

        # 8. metadata + version (reference: src/writer.rs:609-628)
        opt.progress(WriterProgress(MainStep.WRITE_THE_METADATA))
        forest.roots = roots
        forest.repack_normals(ctx.staging_matrix_np(), ctx.staging_aux_np())
        st.metadata = Metadata(dims, all_items, list(roots), metric.name)
        st.version = CURRENT_VERSION
        build_stats.update(
            streaming=streaming,
            budget_items=budget_items,
            mirror_rows=0 if streaming else items_mod.mirror_rows_uploaded,
            deleted=len(to_delete),
            inserted=len(to_insert),
            routed_lanes=routed_lanes,
            seeds=len(seeds),
            seed_items=int(sum(len(s) for _, s in seeds)),
            valve_items=ctx.valve_items,
        )

    # ------------------------------------------------------------------
    def _grow_with_budget(self, ctx: BuildContext, seeds, key) -> None:
        """Grow the oversized descendants, within the memory budget, from
        the threefry ``key`` as the JAX package's writer does.

        Without a budget, the seeds grow in groups, each bounded by three
        caps on its frontier: splits, items, and lanes × storage width;
        group 0 draws from ``key`` and group ``gi`` from
        ``fold_in(key, 0x6B0 + gi)``.  With one, each node popped from a
        stack grows a skeleton from a sampled batch, routes the rest of
        its items through it in batches, and pushes every leaf that
        overflows back onto the stack: the reference's `fit_in_memory` +
        `incremental_index_large_descendant`
        (src/writer.rs:660-739,1536-1584).  A node that fits one batch
        grows whole from ``fold_in(fold_in(key, node), attempt)``; a run
        of such nodes grows in one `grow_streams` pass, which allocates
        node ids as the JAX package's one-by-one grows do."""
        if not seeds:
            return
        if ctx.budget_items is None:
            cap = max(
                min(
                    _GROW_GROUP_SPLITS * ctx.split_after,
                    _GROW_GROUP_ITEMS,
                    _GROW_GROUP_LANE_DIM // max(ctx.metric.storage_dim(ctx.dims), 1),
                ),
                ctx.dims + 1,
            )
            groups: list[list] = [[]]
            total = 0
            for nid, slots in seeds:
                if groups[-1] and total + len(slots) > cap:
                    groups.append([])
                    total = 0
                groups[-1].append((nid, slots))
                total += len(slots)
            for gi, group in enumerate(groups):
                ctx.check_cancel()
                grow_trees(ctx, group, key if gi == 0 else prng.fold_in(key, 0x6B0 + gi))
            return

        rng = np.random.default_rng(prng.key_data(key))
        stack = list(seeds)
        #: regrowth attempts per node: a sampled skeleton can fail to shrink
        #: a pathological node (all-duplicate vectors); after _MAX_REGROW
        #: tries it is written as an oversized leaf, the budget mode's twin
        #: of grow_trees' level cap
        attempts: dict[int, int] = {}
        #: the sampled skeleton batch must itself be splittable, or the
        #: routed remainder collapses back onto its node forever
        cap = max(ctx.budget_items, ctx.dims + 1, ctx.split_after + 1)
        #: the run of nodes that fit one batch, grown together a batch at a time
        whole: list[tuple[np.ndarray, list]] = []
        whole_n = 0
        while stack:
            ctx.check_cancel()
            nid, slots = stack.pop()
            slots = np.asarray(slots, dtype=np.int64)
            att = attempts.get(nid, 0)
            attempts[nid] = att + 1
            if len(slots) <= ctx.split_after or att >= _MAX_REGROW:
                ids = np.sort(ctx.slot_to_id[slots]).astype(np.uint32)
                ctx.forest.put_leaf(nid, ids)
                ctx.on_items_indexed(len(ids))
                if len(slots) > ctx.split_after:
                    ctx.valve_items += len(slots)
                continue
            grow_key = prng.fold_in(prng.fold_in(key, nid), att)
            if whole and (len(slots) > cap or whole_n + len(slots) > cap):
                grow_streams(ctx, whole)
                whole, whole_n = [], 0
            if len(slots) <= cap:
                whole.append((grow_key, [(nid, slots)]))
                whole_n += len(slots)
                continue
            mask = np.zeros(len(slots), bool)
            mask[rng.choice(len(slots), size=cap, replace=False)] = True
            batch, rest = slots[mask], slots[~mask]
            grow_trees(ctx, [(nid, batch)], grow_key)
            # route the remainder through the fresh skeleton in budget
            # batches, each keyed by the offset just past it
            normals = ctx.staging_matrix_dev()
            aux_lookup = ctx.staging_aux_np()
            routed_all: dict[int, list[np.ndarray]] = {}
            for off in range(0, len(rest), cap):
                routed = route_items(
                    ctx, normals, aux_lookup, [(nid, rest[off : off + cap])],
                    prng.fold_in(key, nid * 31 + off + cap),
                )
                for lid, ls in routed.items():
                    routed_all.setdefault(lid, []).extend(ls)
            for lid, slot_lists in routed_all.items():
                old_ids = ctx.forest.leaves.get(lid, np.empty(0, np.uint32))
                old_slots = ctx.ids_to_slots(old_ids) if len(old_ids) else np.empty(0, np.int64)
                merged = np.unique(np.concatenate([old_slots, *slot_lists]))
                if len(merged) <= ctx.split_after:
                    ids = np.sort(ctx.slot_to_id[merged]).astype(np.uint32)
                    ctx.forest.put_leaf(lid, ids)
                    ctx.on_items_indexed(len(ids))
                else:
                    stack.append((lid, merged))
        if whole:
            grow_streams(ctx, whole)

    @staticmethod
    def _delete_items_in_tree(
        forest: Forest, root: int, losing: dict[int, np.ndarray], split_after: int, cancelled
    ) -> int:
        """Prune + collapse pass (reference: src/writer.rs:1021-1114); returns
        the tree's new root.  `losing` maps each leaf that loses items to
        the mask of those items (`_leaves_losing`).

        Iterative post-order over an explicit stack: incremental builds can
        graft subtrees under old leaves build after build, so a tree's
        height has no bound and recursion would exhaust the C stack."""
        # results[nid] = (replacement node, its leaf ids or None for a split)
        results: dict[int, tuple[int, object]] = {}
        stack: list[tuple[int, bool]] = [(int(root), False)]
        while stack:
            cancelled()
            nid, expanded = stack.pop()
            if not expanded:
                if forest.kind[nid] == KIND_LEAF:
                    new = forest.leaves[nid]
                    gone = losing.get(nid)
                    if gone is not None:
                        # `new` is sorted, so the masked select stays so
                        new = new[~gone]
                        forest.put_leaf(nid, new)
                    results[nid] = (nid, new)
                    continue
                stack.append((nid, True))
                stack.append((int(forest.left[nid]), False))
                stack.append((int(forest.right[nid]), False))
                continue
            nl, li = results.pop(int(forest.left[nid]))
            nr, ri = results.pop(int(forest.right[nid]))
            if li is not None and len(li) == 0:
                forest.remove(nl)
                forest.remove(nid)
                results[nid] = (nr, ri)
            elif ri is not None and len(ri) == 0:
                forest.remove(nr)
                forest.remove(nid)
                results[nid] = (nl, li)
            elif li is not None and ri is not None and len(li) + len(ri) <= split_after:
                forest.remove(nl)
                forest.remove(nr)
                merged = np.union1d(li, ri).astype(np.uint32)
                forest.put_leaf(nid, merged)
                results[nid] = (nid, merged)
            else:
                forest.left[nid] = nl
                forest.right[nid] = nr
                results[nid] = (nid, None)
        return int(results[int(root)][0])
