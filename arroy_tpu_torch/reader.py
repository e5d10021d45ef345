"""Reader: query engine entry point, stats, and the validity checker.

Counterpart of `arroy_tpu/reader.py`.  `Reader.open` validates metadata,
distance and pending-update state (reference: src/reader.rs:140-177);
`searcher()` returns a bound serving handle over the database's device.
The exact engine serves every built-in metric (``engine="auto"`` picks
it, as in the JAX package, unless the corpus holds more items than
``ARROY_EXACT_MAX_ITEMS``; a custom metric, which has no exact engine,
goes to the forest).  ``engine="forest"`` serves the leaf-probe
engine (``traversal="probe"``, which ``"auto"`` resolves to at 262,144
items and above) or the reference's best-first traversal
(``traversal="xla"``, and ``"auto"`` below 262,144 items).  `nns(count)`
returns the reference's query builder, whose `by_item` / `by_vector`
and batched `by_items` / `by_vectors` always run the traversal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .errors import InvalidVecDimension, MissingMetadata, NeedBuild, UnmatchingDistance
from .metrics import Metric, resolve_metric
from .models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE
from .search import (
    exact_batch,
    exact_engine_supported,
    make_exact_fn,
    make_search_fn,
    search_batch,
)
from .store.database import Database, IndexState
from .utils.itemset import ItemSet
from .version import Version


@dataclass
class TreeStats:
    """Reference: src/stats.rs:1-23."""

    depth: int
    dummy_normals: int
    split_nodes: int
    descendants: int


@dataclass
class Stats:
    leaf: int
    tree_stats: list[TreeStats]


class QueryBuilder:
    """Reference: src/reader.rs:26-124.  Its `by_*` queries run the
    best-first forest traversal (`search.search_batch`) with the
    per-candidate exact re-score; `Reader.searcher` also uses it to
    resolve the candidate budget."""

    def __init__(self, reader: "Reader", count: int):
        self._reader = reader
        self._count = int(count)
        self._search_k: Optional[int] = None
        self._oversampling: Optional[int] = None
        self._candidates: Optional[ItemSet] = None

    def search_k(self, search_k: int) -> "QueryBuilder":
        if int(search_k) <= 0:
            raise ValueError("search_k must be non-zero")
        self._search_k = int(search_k)
        return self

    def oversampling(self, oversampling: int) -> "QueryBuilder":
        if int(oversampling) <= 0:
            raise ValueError("oversampling must be non-zero")
        self._oversampling = int(oversampling)
        return self

    def candidates(self, candidates) -> "QueryBuilder":
        self._candidates = candidates if isinstance(candidates, ItemSet) else ItemSet(candidates)
        return self

    def _effective_search_k(self) -> int:
        # reference: src/reader.rs:330-335
        search_k = (
            self._search_k
            if self._search_k is not None
            else self._count * max(self._reader.n_trees(), 1)
        )
        mult = (
            self._oversampling
            if self._oversampling is not None
            else self._reader.metric.default_oversampling
        )
        return search_k * mult

    # -- single-query API (arroy parity) --------------------------------
    def by_item(self, item: int) -> Optional[list[tuple[int, float]]]:
        return self.by_items(np.asarray([item], dtype=np.int64))[0]

    def by_vector(self, vector) -> list[tuple[int, float]]:
        vector = np.asarray(vector, dtype=np.float32)
        if vector.ndim != 1:
            raise InvalidVecDimension(self._reader.dimensions(), int(np.prod(vector.shape)))
        return self.by_vectors(vector[None, :])[0]

    # -- batched API -----------------------------------------------------
    def by_items(self, items) -> list[Optional[list[tuple[int, float]]]]:
        """One result list per id; ``None`` for an id that is not in the
        index.  The query is the item's stored leaf (its norm and extra)."""
        r = self._reader
        items = np.asarray(items, dtype=np.int64)
        st = r._state
        present = np.asarray([int(i) in st.store for i in items], bool)
        if not present.any():
            return [None] * len(items)
        slots = st.store.slots_of(items[present].astype(np.uint32))
        qv = st.store.rows()[slots]
        qn = st.store.norms()[slots]
        qe = st.store.extras()[slots]
        qf = qe if r.metric.has_extra else np.ones(len(slots), np.float32)
        res = iter(self._run(qv, qn, qe, qf))
        return [next(res) if p else None for p in present]

    def by_vectors(self, vectors) -> list[list[tuple[int, float]]]:
        r = self._reader
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != r.dimensions():
            raise InvalidVecDimension(
                r.dimensions(), int(vectors.shape[-1] if vectors.ndim else 0)
            )
        qv = r.metric.encode_np(vectors)
        # by_vector builds a fresh leaf via new_header (reference:
        # src/reader.rs:64-75): norm from the codec, extra = 0
        qn = r.metric.item_norms_np(qv, r.dimensions())
        qe = np.zeros(len(qv), np.float32)
        qf = np.zeros(len(qv), np.float32) if r.metric.has_extra else np.ones(len(qv), np.float32)
        return self._run(qv, qn, qe, qf)

    def _run(self, qv, qn, qe, qf) -> list[list[tuple[int, float]]]:
        r = self._reader
        if self._count <= 0 or r._state.metadata is None or len(r._state.metadata.items) == 0:
            return [[] for _ in range(len(qv))]
        filter_slots = None
        if self._candidates is not None:
            inter = self._candidates.intersection(ItemSet.from_sorted(r._state.metadata.items.ids))
            filter_slots = r._state.store.slots_of(inter.ids) if len(inter) else np.empty(0, np.int64)
        return _as_lists(*search_batch(
            r._device(), qv, qn, qe, qf, self._count, self._effective_search_k(), filter_slots
        ))


def _as_lists(ids: np.ndarray, dists: np.ndarray) -> list[list[tuple[int, float]]]:
    out = []
    for row_ids, row_d in zip(ids, dists):
        keep = ~np.isnan(row_d)
        out.append([(int(i), float(d)) for i, d in zip(row_ids[keep], row_d[keep])])
    return out


class Searcher:
    """Bound serving handle over one snapshot, on the database's device.

    ``engine`` selects the whole search strategy:

    - ``"exact"`` (and ``"auto"``, which resolves to it for every
      built-in metric up to ``ARROY_EXACT_MAX_ITEMS`` items) scores
      every item; ``precision`` picks the mode (see `search.make_exact_fn`).
    - ``"forest"`` serves the `search_k` candidate budget through the
      forest (`search.make_search_fn`): the reference's best-first
      traversal (``traversal="xla"``, or ``"auto"`` under 262,144 items),
      the leaf-probe engine (``traversal="probe"``, or ``"auto"`` at
      262,144+ items; tuned by ``probe_trees``, ``probe_block`` and
      ``probe_dtype``) or, when the filter pool fits the budget, an exact
      re-score of the whole pool.  ``rescore`` picks how the traversal's
      candidates are re-scored: ``"exact"`` per candidate, ``"auto"`` by
      a matmul over every item once the candidates outnumber the corpus
      (streamed in chunks past the [B, M] matrix budget).

    ``route`` names the path chosen when the searcher was bound, e.g.
    "fused_select", "bq_matrix", "probe" or "traversal".  The exact
    engine's "f32x1", "f32", "unfused" and "bq_matrix" routes then choose
    per batch: a batch whose [B, M] score matrix would pass the budget
    streams the corpus in chunks instead (`search.scan_calls` counts
    those batches).
    """

    def __init__(
        self,
        reader: "Reader",
        qb: QueryBuilder,
        rescore: str = "auto",
        traversal: str = "auto",
        engine: str = "auto",
        precision: str = "auto",
        multipop="auto",
        probe_trees="auto",
        probe_block="auto",
        probe_dtype="auto",
    ):
        dev = reader._device()
        if engine == "auto":
            # exact whenever the metric supports it; ARROY_EXACT_MAX_ITEMS
            # is the operator's cutoff that sends larger corpora to the
            # forest (as in the JAX package's `Searcher`)
            limit = os.environ.get("ARROY_EXACT_MAX_ITEMS")
            if not exact_engine_supported(dev.metric) or (
                limit is not None and dev.n_items > int(limit)
            ):
                engine = "forest"
            else:
                engine = "exact"
        filter_slots = None
        if qb._candidates is not None:
            inter = qb._candidates.intersection(
                ItemSet.from_sorted(reader._state.metadata.items.ids)
            )
            filter_slots = (
                reader._state.store.slots_of(inter.ids) if len(inter) else np.empty(0, np.int64)
            )
        self._reader = reader
        self._count = qb._count
        self._dev = dev
        self.engine = engine
        if engine == "exact":
            self.device_fn, self.route = make_exact_fn(
                dev, qb._count, filter_slots, precision=precision
            )
        elif engine == "forest":
            self.device_fn, self.route = make_search_fn(
                dev, qb._count, qb._effective_search_k(), filter_slots,
                rescore=rescore, traversal=traversal, multipop=multipop, state=reader._state,
                probe_trees=probe_trees, probe_block=probe_block, probe_dtype=probe_dtype,
            )
        else:
            raise ValueError(f"unknown engine {engine!r}")

    def prepare_queries(self, vectors: np.ndarray):
        """Upload a query matrix once; returns device (qv, qn, qe, qf)."""
        r = self._reader
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != r.dimensions():
            raise InvalidVecDimension(r.dimensions(), int(vectors.shape[-1]))
        qv = r.metric.encode_np(vectors)
        qn = r.metric.item_norms_np(qv, r.dimensions())
        n = len(qv)
        qf = np.zeros(n, np.float32) if r.metric.has_extra else np.ones(n, np.float32)
        if r.metric.binary:
            qv = qv.view(np.int32)
        dev = self._dev.device
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (qv, qn, np.zeros(n, np.float32), qf)
        )

    def __call__(self, vectors: np.ndarray) -> list[list[tuple[int, float]]]:
        """Host convenience: numpy in, result lists out."""
        ids, dists = self.device_fn(*self.prepare_queries(vectors))
        return _as_lists(
            ids.cpu().numpy().astype(np.int64)[:, : self._count],
            dists.cpu().numpy()[:, : self._count],
        )


class Reader:
    """A reader over one committed index snapshot."""

    def __init__(self, state: IndexState, index: int, db: Database, metric: type[Metric]):
        self._state = state
        self._index = index
        self._db = db
        self.metric = metric

    @staticmethod
    def open(rtxn, index: int, db: Database, metric="euclidean") -> "Reader":
        """Reference: src/reader.rs:140-177."""
        metric = resolve_metric(metric)
        st = rtxn.state(index)
        if st is None or st.metadata is None:
            raise MissingMetadata(index)
        if metric.name != st.metadata.distance:
            raise UnmatchingDistance(st.metadata.distance, metric.name)
        if st.updated:
            raise NeedBuild(index)
        return Reader(st, int(index), db, metric)

    # -- introspection (reference: src/reader.rs:179-291) ----------------
    def dimensions(self) -> int:
        return self._state.metadata.dimensions

    def n_trees(self) -> int:
        return len(self._state.metadata.roots)

    def n_items(self) -> int:
        return len(self._state.metadata.items)

    def item_ids(self) -> ItemSet:
        return self._state.metadata.items

    def index(self) -> int:
        return self._index

    def version(self) -> Version:
        return self._state.version

    def n_nodes(self) -> Optional[int]:
        n = self._state.forest.n_nodes() + len(self._state.store)
        return n if n else None

    def item_vector(self, item: int) -> Optional[np.ndarray]:
        return self._state.store.get_vector(item)

    def contains_item(self, item: int) -> bool:
        return int(item) in self._state.store

    def is_empty(self) -> bool:
        return len(self._state.store) == 0

    def iter(self):
        st = self._state
        return ((int(i), st.store.get_vector(int(i))) for i in st.store.ids())

    def nns(self, count: int) -> QueryBuilder:
        return QueryBuilder(self, count)

    def searcher(
        self,
        count: int,
        search_k: int | None = None,
        oversampling: int | None = None,
        candidates=None,
        rescore: str = "auto",
        traversal: str = "auto",
        engine: str = "auto",
        precision: str = "auto",
        multipop="auto",
        probe_trees="auto",
        probe_block="auto",
        probe_dtype="auto",
    ) -> Searcher:
        """A bound serving handle: `device_fn(qv, qn, qe, qf)` takes and
        returns tensors on the database's device (see `Searcher`).

        ``search_k`` and ``oversampling`` set the forest engine's
        candidate budget as `nns(...)` does (reference:
        src/reader.rs:330-335).  ``multipop`` is the best-first
        traversal's pops per step: 1 (what ``"auto"`` means unless
        ``ARROY_MULTIPOP`` says otherwise) is the reference's strict
        order; P > 1 pops the best entry of each of P queue segments a
        step (`search._traverse_multipop`), on the two-tier traversal's
        small tier only, and a filtered search runs at 1.  A custom
        metric (`metrics.register_metric`) has no exact engine, so
        ``engine="auto"`` serves it through the forest."""
        qb = QueryBuilder(self, count)
        if search_k is not None:
            qb.search_k(search_k)
        if oversampling is not None:
            qb.oversampling(oversampling)
        if candidates is not None:
            qb.candidates(candidates)
        return Searcher(
            self, qb, rescore=rescore, traversal=traversal, engine=engine,
            precision=precision, multipop=multipop, probe_trees=probe_trees,
            probe_block=probe_block, probe_dtype=probe_dtype,
        )

    # -- exact search oracle --------------------------------------------
    def exact_by_vectors(self, vectors, count: int, fast: bool = False):
        """Brute-force search: the recall oracle (`fast=False` uses the
        reference's exact distance formulas) or the matmul / popcount
        fast path (`fast=True`)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        qv = self.metric.encode_np(vectors)
        qn = self.metric.item_norms_np(qv, self.dimensions())
        qe = np.zeros(len(qv), np.float32)
        return _as_lists(*exact_batch(self._device(), qv, qn, qe, count, fast=fast))

    def _device(self):
        return self._db.device_index(self._index, self._state)

    # -- stats (reference: src/reader.rs:210-252) ------------------------
    def stats(self) -> Stats:
        f = self._state.forest

        def walk(root: int) -> TreeStats:
            results: dict[int, TreeStats] = {}
            stack = [(int(root), False)]
            while stack:
                nid, expanded = stack.pop()
                k = f.kind[nid]
                if k == KIND_LEAF:
                    results[nid] = TreeStats(
                        depth=1, dummy_normals=0, split_nodes=0, descendants=1
                    )
                    continue
                if not expanded:
                    stack.append((nid, True))
                    stack.append((int(f.left[nid]), False))
                    stack.append((int(f.right[nid]), False))
                    continue
                left = results.pop(int(f.left[nid]))
                right = results.pop(int(f.right[nid]))
                results[nid] = TreeStats(
                    depth=1 + max(left.depth, right.depth),
                    dummy_normals=left.dummy_normals
                    + right.dummy_normals
                    + (1 if k == KIND_SPLIT_NONE else 0),
                    split_nodes=left.split_nodes + right.split_nodes + 1,
                    descendants=left.descendants + right.descendants,
                )
            return results[int(root)]

        return Stats(
            leaf=len(self._state.metadata.items),
            tree_stats=[walk(r) for r in self._state.metadata.roots],
        )

    # -- plot (reference: src/reader.rs:403-469) -------------------------
    def plot_internals_tree_nodes(self) -> str:
        """The first tree as Graphviz dot: normal-less splits in red, each
        edge labelled with the item count of the subtree it leads to."""
        f = self._state.forest
        lines = ["digraph {", "\tlabel=metadata", ""]
        roots = self._state.metadata.roots
        if roots:
            tree = roots[0]
            lines.append("\tsubgraph {")
            lines.append("\t\troot [color=blue]")
            lines.append(f"\t\troot -> {tree}")
            explore = [int(tree)]
            while explore:
                nid = explore.pop()
                k = f.kind[nid]
                if k == KIND_LEAF:
                    lines.append(f'\t\t{nid} [label="{nid}"]')
                elif k in (KIND_SPLIT, KIND_SPLIT_NONE):
                    if k == KIND_SPLIT_NONE:
                        lines.append(f"\t\t{nid} [color=red]")
                    ln, rn = int(f.left[nid]), int(f.right[nid])
                    lines.append(f'\t\t{nid} -> {ln} [taillabel="{len(f.subtree_items(ln))}"]')
                    lines.append(f'\t\t{nid} -> {rn} [taillabel="{len(f.subtree_items(rn))}"]')
                    explore.append(ln)
                    explore.append(rn)
            lines.append("\t}")
        lines.append("}")
        return "\n".join(lines) + "\n"

    # -- invariants (reference: src/reader.rs:509-589) --------------------
    def assert_validity(self) -> None:
        """Every tree reaches all items exactly once; no node sharing."""
        st = self._state
        f = st.forest
        item_ids = ItemSet.from_sorted(st.store.ids())
        all_tree_ids = set(int(i) for i in f.used_node_ids())

        remaining = set(all_tree_ids)
        for root in st.metadata.roots:
            trees: set[int] = set()
            items_arrays: list[np.ndarray] = []
            count_items = 0
            stack = [int(root)]
            while stack:
                nid = stack.pop()
                assert f.kind[nid] != KIND_FREE, f"dangling node {nid}"
                assert nid not in trees, f"node {nid} linked twice in tree {root}"
                trees.add(nid)
                if f.kind[nid] == KIND_LEAF:
                    items_arrays.append(f.leaves[nid])
                    count_items += len(f.leaves[nid])
                else:
                    stack.append(int(f.left[nid]))
                    stack.append(int(f.right[nid]))
            items = (
                ItemSet(np.concatenate(items_arrays)) if items_arrays else ItemSet()
            )
            assert count_items == len(items), (
                f"tree {root}: an item appears twice ({count_items} != {len(items)})"
            )
            assert items == item_ids, f"tree {root} cannot access all items"
            assert trees <= remaining, (
                f"tree {root} shares tree nodes with another tree"
            )
            remaining -= trees
        assert not remaining, f"{sorted(remaining)} tree nodes floating around"
