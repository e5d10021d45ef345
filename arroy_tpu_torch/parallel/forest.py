"""Corpus-sharded forest index over a device mesh.

Counterpart of `arroy_tpu/parallel/forest.py`.  Items are partitioned
round-robin over the mesh's shards, each shard builds its own sub-forest
over its items, and a query fans out to every shard: per-shard
best-first traversal and exact re-score (`search`) or leaf-probe
(`probe_search`) on the shard's device, then a gather of each shard's
top-k and one merge on raw distances (`mesh.merge_topk`): n·k values per
query cross devices.

The per-shard budgets (``search_k' = ceil(search_k / n)``, the pop bound,
the queue and leaf-log widths, the probed blocks per tree and the
re-score cut) are computed once across shards, as the JAX package's one
`shard_map` program has them, and every shard's node table is padded
with FREE rows plus one guaranteed-FREE row that a shard with fewer
trees points its padding roots at.  Recall and latency are those of
``n`` independent arroy indexes whose results are merged exactly (the
standard sharded-ANN construction).
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from ..device import DeviceIndex, leaf_pops_bound
from ..metrics import ALL_METRICS, resolve_metric
from ..models.forest import KIND_FREE
from ..probe import (
    DEFAULT_BLOCK,
    ProbeTables,
    _probe_core,
    _table_tensor,
    block_scale,
    blocks_per_tree,
    build_tables_np,
    rescore_cut,
)
from ..ops.traverse import traverse
from ..search import (
    _expand_log,
    _next_pow2,
    _rescore_batch,
    pop_bound,
    traversal_caps,
)
from ..store.database import Database
from ..writer import Writer
from .mesh import Mesh, merge_topk

_TABLE_KEYS = ("cent", "caux", "valid", "blk_rows", "blk_aux", "blk_slots", "blk_scale")
_TABLE_FILL = {"cent": 0, "caux": 0, "valid": False, "blk_rows": 0, "blk_aux": 0,
               "blk_slots": -1, "blk_scale": 0}


def _pad_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


def _pad_count(ids, dists, count: int):
    ids = ids.cpu().numpy().astype(np.int64)[:, :count]
    dists = dists.cpu().numpy()[:, :count]
    if ids.shape[1] < count:  # NaN-pad, as search_batch does
        pad = count - ids.shape[1]
        ids = np.concatenate([ids, np.zeros((ids.shape[0], pad), ids.dtype)], axis=1)
        dists = np.concatenate([dists, np.full((dists.shape[0], pad), np.nan, dists.dtype)], axis=1)
    return ids, dists


class ShardedForestIndex:
    """n_shards independent sub-forests, queried shard by shard."""

    def __init__(self, mesh: Mesh, packs: list[dict], metric, dims: int, states=None):
        """``packs``: one `DeviceIndex.build_np` pack per shard (either
        package's); ``states``: the shards' (store, forest) handles, which
        the probe packs its block tables from."""
        self.mesh = mesh
        self.metric = metric = resolve_metric(metric)
        self.dims = dims
        self._states = states
        self._probe_cache: dict = {}
        n = mesh.devices.size
        if len(packs) != n:
            raise ValueError(f"{len(packs)} packs for a mesh of {n} shards")

        # common static geometry across shards
        self.max_leaf = max(p["max_leaf"] for p in packs)
        self.n_nodes = max(p["n_nodes"] for p in packs)
        self.n_items_total = sum(p["n_items"] for p in packs)
        self.n_items_shard_max = max(p["n_items"] for p in packs)
        self.csr_total = min(int(p["leaf_items"].shape[0]) - p["max_leaf"] for p in packs)
        t = max(len(p["roots"]) for p in packs)
        self.n_trees = t
        # tight traversal bounds across shards (see search.pops_budget)
        self.n_splits_max = max(int(p.get("n_splits", 0)) for p in packs)
        self.n_dead_max = max(int(p.get("n_dead_pops", 0)) for p in packs)
        self._leaf_cums = [p.get("leaf_cum_np") for p in packs]

        # FREE padding rows, so stray ids read as dead nodes, and one
        # guaranteed-FREE trailing row (id n_rows - 1) that root padding
        # points at: padding with root 0 would walk a real node as a
        # phantom extra tree and spend that shard's budget on duplicates
        n_rows = max(p["node_table"].shape[0] for p in packs) + 1
        n_li = max(p["leaf_items"].shape[0] for p in packs)
        self.shards, self.node_tables, self.roots, self.leaf_items = [], [], [], []
        for s, p in enumerate(packs):
            dev = mesh.devices[s]
            self.shards.append(DeviceIndex.from_numpy(p, metric, dims, dev))
            nt = np.zeros((n_rows, 8), np.int32)
            nt[:, 0] = KIND_FREE
            nt[: p["node_table"].shape[0]] = p["node_table"]
            self.node_tables.append(torch.from_numpy(nt).to(dev))
            roots = _pad_to(np.asarray(p["roots"], np.int64), t, n_rows - 1)
            self.roots.append(torch.from_numpy(roots).to(dev))
            li = _pad_to(np.asarray(p["leaf_items"], np.int32), n_li, -1)
            self.leaf_items.append(torch.from_numpy(li).to(dev))

    def _max_leaf_pops(self, search_k: int) -> int:
        """Worst case over shards of `device.leaf_pops_bound`."""
        return max([1] + [leaf_pops_bound(cum, search_k) for cum in self._leaf_cums])

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        mesh: Mesh,
        vectors: np.ndarray,
        metric="euclidean",
        ids: np.ndarray | None = None,
        n_trees: int | None = None,
        split_after: int | None = None,
        seed: int = 42,
        parallel_build: bool = False,
    ) -> "ShardedForestIndex":
        """Partition items round-robin and build one sub-forest per shard,
        on the shard's device, with seed ``seed + s``.

        ``parallel_build`` drives the shard builds from one thread per
        shard, so builds on different devices overlap; off by default,
        since shards that share a device only queue on it."""
        metric = resolve_metric(metric)
        vectors = np.asarray(vectors, np.float32)
        m, dims = vectors.shape
        if ids is None:
            ids = np.arange(m, dtype=np.uint32)
        n = mesh.devices.size

        def build_shard(s: int):
            sel = np.arange(s, m, n)
            db = Database(device=mesh.devices[s])
            w = Writer(db, 0, dims, metric=metric)
            with db.write() as wtxn:
                if len(sel):
                    w.add_items(wtxn, ids[sel], vectors[sel])
                b = w.builder(seed=seed + s)
                if n_trees is not None:
                    b.n_trees(n_trees)
                if split_after is not None:
                    b.split_after(split_after)
                b.build(wtxn)
            st = db.read().state(0)
            return DeviceIndex.build_np(metric, dims, st.store, st.forest), st

        if parallel_build:
            with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
                results = list(ex.map(build_shard, range(n)))
        else:
            results = [build_shard(s) for s in range(n)]
        return ShardedForestIndex(mesh, [p for p, _ in results], metric, dims,
                                  states=[st for _, st in results])

    # ------------------------------------------------------------------
    def _queries(self, queries, s: int):
        """(qv, qn, qe, qf) of the query batch on shard s's device."""
        metric = self.metric
        qv = metric.encode_np(np.asarray(queries, np.float32))
        qn = metric.item_norms_np(qv, self.dims)
        b = len(qv)
        qe = np.zeros(b, np.float32)
        qf = np.zeros(b, np.float32) if metric.has_extra else np.ones(b, np.float32)
        if qv.dtype == np.uint32:
            qv = qv.view(np.int32)
        return tuple(torch.from_numpy(a).to(self.mesh.devices[s]) for a in (qv, qn, qe, qf))

    def _default_search_k(self, count: int) -> int:
        # the single-device default budget (reader._effective_search_k):
        # count x total trees, x the metric's oversampling (x3 for BQ)
        return count * self.n_trees * self.mesh.devices.size * self.metric.default_oversampling

    def plan(self, count: int, search_k: int | None = None) -> dict:
        """The traversal budgets every shard runs under, computed once
        across shards (`arroy_tpu/parallel/forest.py:198-210`)."""
        n = self.mesh.devices.size
        if search_k is None:
            search_k = self._default_search_k(count)
        sk_local = min(max(-(-search_k // n), count), max(self.csr_total, 1))
        sk = _next_pow2(sk_local)
        t = self.n_trees
        leaf_pops = self._max_leaf_pops(sk)
        pmax = pop_bound(self.n_nodes, t, self.n_splits_max, self.n_dead_max, leaf_pops, sk_local,
                         sk_local >= self.n_items_shard_max)
        q_cap, l_cap = traversal_caps(t, pmax, self.n_splits_max, sk, leaf_pops)
        return dict(sk_local=sk_local, sk=sk, pmax=pmax,
                    k=max(min(_next_pow2(count), sk + self.max_leaf), 1), q_cap=q_cap, l_cap=l_cap)

    def shard_search(self, s: int, plan: dict, qv, qn, qe, qf, margins=None):
        """Shard s's traversal and exact re-score → (ids [B, k], raw
        distances, +inf where dead).  ``margins`` [B, S] replace the
        shard's own (a test hands in the JAX package's)."""
        idx = self.shards[s]
        if margins is None:
            margins = self.metric.margin_matrix(idx.normals, idx.aux, qv, qf)
        log, _, _ = traverse(
            margins, self.node_tables[s], self.leaf_items[s], self.roots[s], plan["sk"],
            plan["sk_local"], plan["pmax"], self.max_leaf, q_cap=plan["q_cap"], l_cap=plan["l_cap"],
        )
        cand = _expand_log(log, idx.leaf_off, idx.leaf_cnt, self.leaf_items[s],
                           plan["sk"] + self.max_leaf)
        return _rescore_batch(self.metric, self.dims, plan["k"], idx.rows, idx.norms, idx.extras,
                              idx.slot_to_id, cand, qv, qn, qe, normalize=False)

    def search(self, queries: np.ndarray, count: int, search_k: int | None = None):
        """Fan-out query: returns numpy (ids [B, count] int64, dists [B, count])."""
        b = len(np.asarray(queries))
        if self.n_items_total == 0 or self.n_trees == 0:
            return np.zeros((b, count), np.int64), np.full((b, count), np.nan, np.float32)
        plan = self.plan(count, search_k)
        parts = [self.shard_search(s, plan, *self._queries(queries, s)) for s in range(self.mesh.devices.size)]
        return _pad_count(*merge_topk(self.metric, self.dims, count, parts, self.mesh.devices[0]),
                          count)

    # ------------------------------------------------------------------
    # leaf-probe fan-out
    # ------------------------------------------------------------------
    def enable_probe(self, n_trees="auto", block="auto", dtype="bf16"):
        """Pack and upload every shard's leaf-probe block tables (probe.py),
        each padded to the widest shard's blocks per tree, so that one
        probe geometry serves every shard.  Called by `probe_search`;
        cached per geometry."""
        if self._states is None:
            raise ValueError("the probe fan-out needs per-shard states (build())")
        P = DEFAULT_BLOCK if block == "auto" else int(block)
        T_req = 8 if n_trees == "auto" else int(n_trees)
        key = (T_req, P, dtype)
        hit = self._probe_cache.get(key)
        if hit is not None:
            return hit
        T = min(min(T_req, len(st.forest.roots) or 1) for st in self._states)
        tabs = [build_tables_np(self.metric, self.dims, st.store, st.forest, T, P, dtype)
                for st in self._states]
        nb = max(t["nb_max"] for t in tabs)

        def repad(t, key_):
            a = t[key_]
            if key_ == "blk_scale" and a.shape[0] == 1:
                return a  # the [1, 1] placeholder of non-int8 tables
            a = a.reshape((t["n_trees"], t["nb_max"]) + a.shape[1:])
            a = np.concatenate([a, np.full((t["n_trees"], nb - t["nb_max"]) + a.shape[2:],
                                           _TABLE_FILL[key_], a.dtype)], axis=1)
            return a.reshape((t["n_trees"] * nb,) + a.shape[2:])

        fill = float(np.mean([t["fill"] for t in tabs]))
        pack = [
            ProbeTables(n_trees=T, block=P, nb_max=nb, fill=fill,
                        **{k: _table_tensor(repad(t, k), self.mesh.devices[s]) for k in _TABLE_KEYS})
            for s, t in enumerate(tabs)
        ]
        self._probe_cache[key] = pack
        return pack

    def probe_plan(self, count: int, search_k: int | None, tables: list, dtype: str) -> dict:
        """The probe's budgets, once across shards: blocks per tree ``L``
        from the mean leaf-padding fill, and the re-score cut of
        `probe.rescore_cut`, the single-device probe's rule."""
        if search_k is None:
            search_k = self._default_search_k(count)
        sk_local = max(-(-int(search_k) // self.mesh.devices.size), count)
        t0 = tables[0]
        T, P = t0.n_trees, t0.block
        L = blocks_per_tree(T, P, t0.fill, sk_local, t0.nb_max)
        k = max(1, int(count))
        k2 = rescore_cut(k, sk_local, T * L * P, sign_bits=dtype == "bq" and not self.metric.binary,
                         custom=self.metric not in ALL_METRICS)
        return dict(k=k, k2=k2, L=L)

    def probe_search(
        self,
        queries: np.ndarray,
        count: int,
        search_k: int | None = None,
        n_trees="auto",
        block="auto",
        dtype: str = "bf16",
    ):
        """Leaf-probe fan-out: each shard ranks, scores (kernel 3 on a card,
        for bf16, int8 and f32 tables) and re-scores its own block tables,
        then one merge of the per-shard top-k on raw distances: the sharded
        twin of `probe.make_probe_fn`."""
        b = len(np.asarray(queries))
        if self.n_items_total == 0 or self.n_trees == 0:
            return np.zeros((b, count), np.int64), np.full((b, count), np.nan, np.float32)
        tables = self.enable_probe(n_trees=n_trees, block=block, dtype=dtype)
        plan = self.probe_plan(count, search_k, tables, dtype)
        scale = block_scale(self.metric)
        parts = []
        for s, (idx, t) in enumerate(zip(self.shards, tables)):
            qv, qn, qe, _ = self._queries(queries, s)
            parts.append(_probe_core(
                self.metric, self.dims, plan["k"], plan["k2"], plan["L"], t.nb_max, scale,
                t.cent, t.caux, t.valid, t.blk_rows, t.blk_aux, t.blk_slots, t.blk_scale,
                idx.rows, idx.norms, idx.extras, idx.slot_to_id, qv, qn, qe, normalize=False,
            ))
        return _pad_count(*merge_topk(self.metric, self.dims, count, parts, self.mesh.devices[0]),
                          count)
