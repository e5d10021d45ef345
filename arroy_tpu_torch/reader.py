"""Reader: query engine entry point, stats, and the validity checker.

Counterpart of `arroy_tpu/reader.py`.  `Reader.open` validates metadata,
distance and pending-update state (reference: src/reader.rs:140-177);
`searcher()` returns a bound serving handle over the database's device.
The exact engine serves every built-in metric (``engine="auto"`` picks
it, as in the JAX package).  The forest traversal — ``engine="forest"``
and the `nns(...)` query builder — is not ported yet and raises
`NotImplementedError` (ROADMAP queue 1: forest traversal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .errors import InvalidVecDimension, MissingMetadata, NeedBuild, UnmatchingDistance
from .metrics import ALL_METRICS, Metric, resolve_metric
from .models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT_NONE
from .search import exact_batch, exact_engine_supported, make_exact_fn
from .store.database import Database, IndexState
from .utils.itemset import ItemSet
from .version import Version

_TRAVERSAL_TODO = (
    "the forest traversal is not ported yet (ROADMAP queue 1: forest "
    "traversal and nns()); use searcher(engine='exact')"
)


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
    """Reference: src/reader.rs:26-124.  Queries run through the forest
    traversal, which is not ported yet."""

    def __init__(self, reader: "Reader", count: int):
        self._reader = reader
        self._count = int(count)
        self._candidates: Optional[ItemSet] = None

    def candidates(self, candidates) -> "QueryBuilder":
        self._candidates = candidates if isinstance(candidates, ItemSet) else ItemSet(candidates)
        return self

    def by_item(self, item: int):
        raise NotImplementedError(_TRAVERSAL_TODO)

    def by_items(self, items):
        raise NotImplementedError(_TRAVERSAL_TODO)

    def by_vector(self, vector):
        raise NotImplementedError(_TRAVERSAL_TODO)

    def by_vectors(self, vectors):
        raise NotImplementedError(_TRAVERSAL_TODO)


def _as_lists(ids: np.ndarray, dists: np.ndarray) -> list[list[tuple[int, float]]]:
    out = []
    for row_ids, row_d in zip(ids, dists):
        keep = ~np.isnan(row_d)
        out.append([(int(i), float(d)) for i, d in zip(row_ids[keep], row_d[keep])])
    return out


class Searcher:
    """Bound serving handle over one snapshot, on the database's device.

    ``engine="exact"`` (and ``"auto"``, which resolves to it for every
    built-in metric) scores every item; ``precision`` picks the mode (see
    `search.make_exact_fn`).  ``route`` names the stage-1 path the
    searcher took, e.g. "fused_select" or "bq_matrix".
    """

    def __init__(self, reader: "Reader", count: int, candidates=None,
                 engine: str = "auto", precision: str = "auto"):
        dev = reader._device()
        if engine == "auto":
            engine = "exact" if exact_engine_supported(dev.metric) else "forest"
        if engine != "exact":
            raise NotImplementedError(_TRAVERSAL_TODO)
        filter_slots = None
        if candidates is not None:
            cand = candidates if isinstance(candidates, ItemSet) else ItemSet(candidates)
            inter = cand.intersection(ItemSet.from_sorted(reader._state.metadata.items.ids))
            filter_slots = (
                reader._state.store.slots_of(inter.ids) if len(inter) else np.empty(0, np.int64)
            )
        self._reader = reader
        self._count = int(count)
        self._dev = dev
        self.engine = engine
        self.device_fn, self.route = make_exact_fn(dev, count, filter_slots, precision=precision)

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
        candidates=None,
        engine: str = "auto",
        precision: str = "auto",
    ) -> Searcher:
        """A bound serving handle: `device_fn(qv, qn, qe, qf)` takes and
        returns tensors on the database's device."""
        if self.metric not in ALL_METRICS:
            raise NotImplementedError(_TRAVERSAL_TODO)
        return Searcher(self, count, candidates=candidates, engine=engine, precision=precision)

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
