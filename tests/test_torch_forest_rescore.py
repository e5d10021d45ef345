"""The forest engines' exact re-scores on kernel 5's entry, on the CPU.

The probe's stage 3 (`probe._probe_core`, single and sharded) and the
traversal's per-candidate re-score (`search._rescore_batch`: `nns()`,
`TraversalFn` in its "exact" mode, the filter pool, the sharded forest)
dedup their candidates as plain ops, then, for euclidean, cosine and
dot-product on a CUDA device, make one `ops.rescore.rescore_topk` launch
a batch (`ops.rescore.forest_rescore`); every other metric, and every
metric on the CPU, keeps the plain chain.

* Against the JAX package on one state: the port's `_probe_core` and the
  JAX package's on the same JAX-built forest and block tables, and the
  port's `_rescore_batch` and the JAX package's `_rescore_impl` on one
  `DeviceIndex.from_numpy` state, over duplicates, -1 pads, queries with
  fewer than k valid candidates (and none), an item id of u32::MAX, raw
  and normalized distances.  Both routes are held: the plain chain the
  CPU serves, and the kernel's route with `forest_kernel` answering as
  for a CUDA device and `rescore_topk` bound to a recorder that runs its
  plain version (`rescore_topk_reference`), so the route's own code (the
  clamp of -1 slots, the validity mask, the probe's id rule on NaN
  lanes) runs here.
* Against the pre-kernel chain: a copy of each as it stood before kernel
  5 took these paths is the oracle, and the CPU's answers equal it bit
  for bit.
* Which paths reach the entry: the probe, `nns()`, the filter pool, the
  sharded forest and the sharded probe call it once a batch (a shard)
  for the three metrics, never for manhattan, a BQ metric or a
  registered metric.

Tolerances: ids equal tie-aware, distances rtol 1e-5 with an absolute
floor of 1e-6 (f32 sums in another order), NaN (normalized) and +inf
(raw) at the same places.  A raw +inf lane has no valid candidate, so
its id is not compared; a normalized NaN lane's id is 0 in the probe and
is compared there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import probe as j_probe
from arroy_tpu import search as j_search
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu.metrics import metric_by_name as j_metric
from arroy_tpu.models.forest import Forest
from arroy_tpu.models.items import ItemStore
from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch import metrics as t_metrics
from arroy_tpu_torch import probe as t_probe
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.device import DeviceIndex
from arroy_tpu_torch.metrics import metric_by_name as t_metric
from arroy_tpu_torch.ops import rescore as rs
from arroy_tpu_torch.parallel.forest import ShardedForestIndex
from arroy_tpu_torch.parallel.mesh import make_mesh

from .torch_util import query_arrays, tie_aware_equal, to_torch

M, DIM, TREES, K = 2000, 32, 6, 10
TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_METRICS = ("euclidean", "cosine", "dot-product")
_INF = float("inf")


class ForestRescoreEuclidean(t_metrics.Euclidean):
    """A registered metric (euclidean's formulas under another name)."""

    name = "forest-rescore-euclidean"


# ---------------------------------------------------------------------------
# the kernel's route on the CPU, and the pre-kernel chains
# ---------------------------------------------------------------------------


class Recorder:
    """Stands in for `ops.rescore.rescore_topk`: checks what the kernel's
    wrapper checks (but the device), records the call, and answers with
    the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe,
                 normalize=True):
        b, c = cand.shape
        assert metric.name in rs.METRICS
        assert cand.dtype == torch.int64 and valid.dtype == torch.bool and valid.shape == (b, c)
        assert all(t.is_contiguous() for t in (cand, valid, qv, qn))
        assert 1 <= k <= c and b * c <= rs.MAX_CANDIDATES and qv.shape[0] == b
        assert b == 0 or 0 <= int(cand.min()) <= int(cand.max()) < rows.shape[0]
        self.calls.append((b, c, k, normalize))
        return rs.rescore_topk_reference(metric, dims, k, cand, valid, rows, norms, extras,
                                         slot_to_id, qv, qn, qe, normalize)


def _kernel_route(monkeypatch):
    """Route the forest re-scores as on a CUDA device; returns the recorder."""
    rec = Recorder()
    as_card = lambda metric, device: rs.forest_kernel(metric, "cuda")  # noqa: E731
    monkeypatch.setattr(t_probe, "forest_kernel", as_card)
    monkeypatch.setattr(t_search, "forest_kernel", as_card)
    monkeypatch.setattr(rs, "rescore_topk", rec)
    return rec


def _old_probe_stage3(metric, dims, k, ss, live, rows, norms, extras, slot_to_id, qv, qn, qe,
                      normalize):
    """`probe._probe_core`'s stage 3 after the dedup, before kernel 5."""
    b = qv.shape[0]

    def exact_chunk(slots_c, live_c):
        cs = torch.clamp(slots_c, min=0)
        d = metric.built_distance(
            qv[:, None, :], qn[:, None], qe[:, None], rows[cs], norms[cs], extras[cs]
        )
        return torch.where(live_c, d, _INF)

    kq = ss.shape[1]
    ck = max(k, int(t_probe.PROBE_GATHER_BYTES) // max(b * rows.shape[1] * 8, 1))
    if kq <= ck:
        out_d, top_i = torch.topk(exact_chunk(ss, live), k, dim=1, largest=False)
        sel_slots = torch.gather(ss, 1, top_i)
    else:
        nch = -(-kq // ck)
        pad = nch * ck - kq
        ss = torch.nn.functional.pad(ss, (0, pad), value=-1)
        live = torch.nn.functional.pad(live, (0, pad), value=False)
        ds, sl = [], []
        for i in range(nch):
            cs, lv = ss[:, i * ck : (i + 1) * ck], live[:, i * ck : (i + 1) * ck]
            dc, ic = torch.topk(exact_chunk(cs, lv), k, dim=1, largest=False)
            ds.append(dc)
            sl.append(torch.gather(cs, 1, ic))
        out_d, top_i = torch.topk(torch.cat(ds, dim=1), k, dim=1, largest=False)
        sel_slots = torch.gather(torch.cat(sl, dim=1), 1, top_i)
    ids = slot_to_id[torch.clamp(sel_slots, min=0)]
    if not normalize:
        return ids, out_d
    out_d = torch.where(out_d < _INF, metric.normalized_distance(out_d, dims), float("nan"))
    ids = torch.where(torch.isnan(out_d), 0, ids)
    return ids, out_d


def _old_rescore_batch(metric, dims, k, rows, norms, extras, slot_to_id, cand, qv, qn, qe,
                       normalize=True):
    """`search._rescore_batch` before kernel 5."""
    valid0 = cand >= 0
    ids = slot_to_id[torch.clamp(cand, min=0)]
    key = ids + (~valid0).to(torch.int64) * (1 << 32)
    order = torch.argsort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    valid_s = torch.gather(valid0, 1, order)
    slots_s = torch.clamp(torch.gather(cand, 1, order), min=0)
    dup = torch.zeros_like(valid_s)
    dup[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & valid_s[:, :-1]
    invalid = ~valid_s | dup
    d = torch.cat([
        metric.built_distance(qv[:, None, :], qn[:, None], qe[:, None], rows[sl], norms[sl],
                              extras[sl])
        for sl in torch.split(slots_s, t_search._RESCORE_CHUNK, dim=1)
    ], dim=1)
    return rs.finish_topk(metric, dims, k, torch.where(invalid, _INF, d), slot_to_id, slots_s,
                          normalize)


def _bit_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def _assert_agree(ids, d, jids, jd, raw):
    """Tie-aware equality (module docstring); ``raw``: +inf lanes' ids are
    not compared."""
    ids, d, jids, jd = (np.asarray(a) for a in (ids, d, jids, jd))
    np.testing.assert_array_equal(np.isnan(d), np.isnan(jd))
    np.testing.assert_array_equal(np.isinf(d), np.isinf(jd))
    if not raw:  # a NaN lane's id is compared as it is
        tie_aware_equal(ids, np.nan_to_num(d, nan=-1.0), jids, np.nan_to_num(jd, nan=-1.0), **TOL)
        return
    dead = np.isinf(d)
    d, jd = np.where(dead, np.nan, d), np.where(dead, np.nan, jd)
    for i in range(len(ids)):
        live = ~dead[i]
        if live.any():
            tie_aware_equal(ids[i, live][None], d[i, live][None], jids[i, live][None],
                            jd[i, live][None], **TOL)


# ---------------------------------------------------------------------------
# the probe's stage 3 against the JAX package
# ---------------------------------------------------------------------------


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((16, DIM)).astype(np.float32)
    pa, pb = rng.integers(16, size=M), rng.integers(16, size=M)
    x = np.where(rng.random((M, DIM)) < 0.5, parents[pa], parents[pb]).astype(np.float32)
    x += 0.05 * rng.standard_normal((M, DIM)).astype(np.float32)
    q = x[rng.integers(M, size=24)] + 0.3 * rng.standard_normal((24, DIM)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """metric -> (JAX Reader, port Reader, queries) over one JAX-built index."""
    x, q = _corpus()
    built = {}

    def get(metric):
        if metric not in built:
            path = str(tmp_path_factory.mktemp(metric.replace(" ", "_")))
            db = arroy_tpu.Database(path)
            w = arroy_tpu.Writer(db, 0, DIM, metric=metric)
            with db.write() as wtxn:
                w.add_items(wtxn, np.arange(M, dtype=np.uint32), x)
                w.builder(seed=7).n_trees(TREES).build(wtxn)
            jr = arroy_tpu.Reader.open(db.read(), 0, db, metric=metric)
            tdb = arroy_tpu_torch.Database(path, device="cpu")
            tr = arroy_tpu_torch.Reader.open(tdb.read(), 0, tdb, metric=metric)
            built[metric] = (jr, tr, q)
        return built[metric]

    return get


def _probe_both(jr, tr, q, normalize, n_filter):
    """`_probe_core` of both packages on the same forest, bf16 block tables
    (packed words for a BQ metric), T = 4, P = 16, search_k 600; with
    ``n_filter``, only that many random ids pass (fewer than k found)."""
    T, P, sk = 4, 16, 600
    jdev, tdev = jr._device(), tr._device()
    jm, tm = jdev.metric, tdev.metric
    dtype = "bq" if jm.binary else "bf16"
    jt = j_probe.get_tables(jdev, jr._state, T, P, dtype)
    tt = t_probe.get_tables(tdev, tr._state, T, P, dtype)
    L = t_probe.blocks_per_tree(T, P, tt.fill, sk, tt.nb_max)
    k2 = t_probe.rescore_cut(K, sk, T * L * P, False, False)
    scale = t_probe.block_scale(tm)
    fwords, fmask, has_filter = jnp.zeros(1, jnp.uint32), None, n_filter is not None
    if has_filter:
        ids = np.random.default_rng(3).choice(M, n_filter, replace=False).astype(np.uint32)
        slots = tr._state.store.slots_of(ids)
        words = np.zeros(max((jdev.cap + 31) // 32, 1), np.uint32)
        np.bitwise_or.at(words, slots >> 5, np.uint32(1) << (slots & 31).astype(np.uint32))
        fwords = jnp.asarray(words)
        fmask = torch.zeros(tdev.cap, dtype=torch.bool)
        fmask[torch.from_numpy(slots.astype(np.int64))] = True
    qa = query_arrays(jm, q)
    want = j_probe._probe_impl(
        jm, DIM, K, k2, L, jt.nb_max, scale, jt.cent, jt.caux, jt.valid, jt.blk_rows,
        jt.blk_aux, jt.blk_slots, jt.blk_scale, jdev.rows, jdev.norms, jdev.extras,
        jdev.slot_to_id, *(jnp.asarray(a) for a in qa[:3]), normalize=normalize, fwords=fwords,
        has_filter=has_filter)
    want = tuple(np.asarray(a) for a in want)

    def port():
        return t_probe._probe_core(
            tm, DIM, K, k2, L, tt.nb_max, scale, tt.cent, tt.caux, tt.valid, tt.blk_rows,
            tt.blk_aux, tt.blk_slots, tt.blk_scale, tdev.rows, tdev.norms, tdev.extras,
            tdev.slot_to_id, *(to_torch(a) for a in qa[:3]), fmask=fmask, normalize=normalize)

    return want[0].astype(np.int64), want[1], port


@pytest.mark.parametrize("metric,normalize,n_filter", [
    (m, n, None) for m in (*KERNEL_METRICS, "manhattan", "binary quantized cosine")
    for n in (True, False)
] + [("euclidean", True, 4), ("cosine", False, 4), ("dot-product", True, 0)])
def test_probe_stage3_matches_jax(index, monkeypatch, metric, normalize, n_filter):
    """Both routes of the port's probe answer as the JAX package's; the
    plain chain equals the pre-kernel stage 3 bit for bit; the kernel's
    route makes one call for the three metrics, none for the others."""
    jr, tr, q = index(metric)
    jids, jd, port = _probe_both(jr, tr, q, normalize, n_filter)
    seen = []
    real = t_probe._rescore_slots

    def record(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(t_probe, "_rescore_slots", record)
    plain = port()
    (args,) = seen
    _bit_equal(plain, _old_probe_stage3(*args))
    _assert_agree(*plain, jids, jd, raw=not normalize)
    if n_filter is not None:  # fewer than k found
        assert np.isnan(jd).any() if normalize else np.isinf(jd).any()
    rec = _kernel_route(monkeypatch)
    routed = port()
    assert len(rec.calls) == (1 if metric in KERNEL_METRICS else 0), rec.calls
    _assert_agree(*routed, jids, jd, raw=not normalize)
    if metric not in KERNEL_METRICS:
        _bit_equal(routed, plain)


# ---------------------------------------------------------------------------
# the traversal's re-score against the JAX package
# ---------------------------------------------------------------------------

U32_MAX = 2**32 - 1


def _rescore_state(metric, m=600, d=24, seed=5):
    """(JAX DeviceIndex, port DeviceIndex, corpus) over one JAX store whose
    item 17 has the id u32::MAX."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    ids = np.arange(m, dtype=np.uint32)
    ids[17] = U32_MAX
    jm = j_metric(metric)
    store = ItemStore(jm, d)
    store.put_many(ids, x)
    if jm.has_extra:
        slots = store.slots_of(store.ids())
        norms, extras = jm.preprocess_np(store.rows()[slots])
        store.set_preprocess(norms, extras, slots)
    jidx = JDeviceIndex.build(jm, d, store, Forest())
    tidx = DeviceIndex.from_numpy(JDeviceIndex.build_np(jm, d, store, Forest()), t_metric(metric),
                                  d, "cpu")
    return jidx, tidx, x, store.slots_of(np.asarray([U32_MAX], np.uint32))[0]


def _candidates(m, b, cap, max_slot, seed=6):
    """[B, cap] candidate slots: a third duplicates of other columns (the
    u32::MAX item's slot among them in every other query), a fifth -1
    pads; query 1 has 3 valid slots, query 2 none."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(m, size=(b, cap))
    dup = rng.random((b, cap)) < 0.33
    cand[dup] = cand[np.nonzero(dup)[0], rng.integers(cap, size=int(dup.sum()))]
    cand[::2, 3] = cand[::2, 9] = cand[::2, 40] = max_slot
    cand[rng.random((b, cap)) < 0.2] = -1
    cand[1] = -1
    cand[1, [5, 20, 21]] = [4, 8, 4]  # two distinct valid, one duplicate
    cand[2] = -1
    return cand


@pytest.mark.parametrize("metric", [*KERNEL_METRICS, "manhattan", "binary quantized euclidean"])
@pytest.mark.parametrize("normalize", [True, False])
def test_rescore_batch_matches_jax(monkeypatch, metric, normalize):
    """`_rescore_batch` on both routes against the JAX package's
    `_rescore_impl` on one state (duplicates, -1 pads, fewer than k valid,
    none valid, an id of u32::MAX), and the plain route bit-equal to the
    pre-kernel chain."""
    jidx, tidx, x, max_slot = _rescore_state(metric)
    rng = np.random.default_rng(8)
    q = x[rng.integers(len(x), size=12)] + 0.3 * rng.standard_normal((12, x.shape[1]))
    q[0] = x[max_slot] + 0.01 * rng.standard_normal(x.shape[1])  # the u32::MAX item's neighbour
    qa = query_arrays(j_metric(metric), q.astype(np.float32))
    cand = _candidates(len(x), 12, 96, max_slot)
    jids, jd = j_search._rescore_impl(
        jidx.metric, jidx.dims, K, jidx.rows, jidx.norms, jidx.extras, jidx.slot_to_id,
        jnp.asarray(cand, jnp.int32), *(jnp.asarray(a) for a in qa[:3]), normalize=normalize)
    jids, jd = np.asarray(jids).astype(np.int64), np.asarray(jd)
    args = (tidx.metric, tidx.dims, K, tidx.rows, tidx.norms, tidx.extras, tidx.slot_to_id,
            torch.from_numpy(cand), *(to_torch(a) for a in qa[:3]))
    plain = t_search._rescore_batch(*args, normalize=normalize)
    _bit_equal(plain, _old_rescore_batch(*args, normalize=normalize))
    _assert_agree(*plain, jids, jd, raw=True)
    assert U32_MAX in plain[0][0].tolist() or metric == "dot-product"
    dead = np.isnan(jd) if normalize else np.isinf(jd)
    assert dead[1].sum() == K - 2 and dead[2].all() and not dead[0].any()
    rec = _kernel_route(monkeypatch)
    routed = t_search._rescore_batch(*args, normalize=normalize)
    assert len(rec.calls) == (1 if metric in KERNEL_METRICS else 0), rec.calls
    _assert_agree(*routed, jids, jd, raw=True)
    # every query's u32::MAX item counted once: no id twice in a row
    for row, drow in zip(routed[0].numpy(), routed[1].numpy()):
        live = row[np.isfinite(drow)]
        assert len(set(live.tolist())) == len(live)


# ---------------------------------------------------------------------------
# which paths reach kernel 5's entry
# ---------------------------------------------------------------------------

SPY_METRICS = (*KERNEL_METRICS, "manhattan", "binary quantized cosine", ForestRescoreEuclidean.name)
PATHS = ("probe", "nns", "traversal exact", "filter pool", "sharded forest", "sharded probe")


@pytest.fixture(scope="module")
def spy_index():
    """metric -> (port Reader, sharded index over 2 CPU shards, queries),
    1,200 x 16, built by the port on the CPU."""
    t_metrics.register_metric(ForestRescoreEuclidean)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    q = x[:9] + 0.3 * rng.standard_normal((9, 16)).astype(np.float32)
    built = {}

    def get(metric):
        if metric not in built:
            db = Database(None, device="cpu")
            w = Writer(db, 0, 16, metric=metric)
            with db.write() as wtxn:
                w.add_items(wtxn, np.arange(1200), x)
                w.builder(seed=4).n_trees(4).build(wtxn)
            sharded = ShardedForestIndex.build(make_mesh(2, device="cpu"), x, metric=metric,
                                               n_trees=3, seed=4)
            built[metric] = (Reader.open(db.read(), 0, db, metric=metric), sharded, q)
        return built[metric]

    return get


def _run_path(path, r, sharded, q):
    """One call of the path on the queries → (ids, dists) as numpy, and the
    launches it should make where the kernel serves its metric."""
    if path == "probe":
        s = r.searcher(K, search_k=400, engine="forest", traversal="probe", probe_trees=4,
                       probe_block=16)
        assert s.route == "probe"
        return _lists(s(q)), 1
    if path == "nns":
        return _lists(r.nns(K).search_k(400).by_vectors(q)), 1
    if path == "traversal exact":
        s = r.searcher(K, search_k=400, engine="forest", traversal="xla", rescore="exact")
        assert s.route == "traversal" and s.device_fn.rescore_mode(len(q)) == "exact"
        return _lists(s(q)), 1
    if path == "filter pool":
        s = r.searcher(K, search_k=400, engine="forest", candidates=np.arange(0, 1200, 30))
        assert s.route == "filter_pool"
        assert t_search.rescore_mode(r.metric, len(q), 64, 1200) == "exact"
        return _lists(s(q)), 1
    if path == "sharded forest":
        return sharded.search(q, K, search_k=400), 2
    tables = "bq" if sharded.metric.binary else "bf16"
    return sharded.probe_search(q, K, search_k=400, n_trees=3, block=16, dtype=tables), 2


def _lists(res):
    ids = np.zeros((len(res), K), np.int64)
    d = np.full((len(res), K), np.nan, np.float32)
    for i, row in enumerate(res):
        ids[i, : len(row)] = [j for j, _ in row]
        d[i, : len(row)] = [v for _, v in row]
    return ids, d


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("metric", SPY_METRICS)
def test_forest_paths_reach_kernel5_by_metric(spy_index, monkeypatch, path, metric):
    """Routed as on the card, each path calls `rescore_topk` once a batch (a
    shard) for the three metrics and never for the others, and answers as
    its plain chain does."""
    r, sharded, q = spy_index(metric)
    want, _ = _run_path(path, r, sharded, q)
    rec = _kernel_route(monkeypatch)
    got, calls = _run_path(path, r, sharded, q)
    assert len(rec.calls) == (calls if metric in KERNEL_METRICS else 0), rec.calls
    _assert_agree(*got, *want, raw=False)


def test_forest_kernel_by_metric_and_device():
    for name in KERNEL_METRICS:
        assert rs.forest_kernel(t_metric(name), "cuda")
        assert rs.forest_kernel(t_metric(name), torch.device("cuda", 1))
        assert not rs.forest_kernel(t_metric(name), "cpu")
    for name in ("manhattan", "binary quantized euclidean", "binary quantized manhattan",
                 "binary quantized cosine"):
        assert not rs.forest_kernel(t_metric(name), "cuda")
    assert not rs.forest_kernel(ForestRescoreEuclidean, "cuda")


def test_forest_rescore_splits_queries_past_the_launch_limit(monkeypatch):
    """Where B · c passes `MAX_CANDIDATES`, one launch a chunk of queries
    (here the limit is lowered to 100: 3 queries of 32 candidates a
    launch), and the answers are those of one call."""
    jidx, tidx, x, _ = _rescore_state("cosine")
    rng = np.random.default_rng(9)
    qa = query_arrays(j_metric("cosine"), x[:7] + 0.2 * rng.standard_normal((7, x.shape[1])))
    cand = torch.from_numpy(rng.integers(len(x), size=(7, 32)))
    valid = torch.from_numpy(rng.random((7, 32)) < 0.9)
    args = (tidx.metric, tidx.dims, K, cand, valid, tidx.rows, tidx.norms, tidx.extras,
            tidx.slot_to_id, *(to_torch(a.astype(np.float32)) for a in qa[:3]))
    whole = rs.rescore_topk_reference(*args)
    rec = _kernel_route(monkeypatch)
    monkeypatch.setattr(rs, "MAX_CANDIDATES", 100)
    parts = rs.forest_rescore(*args)
    assert rec.calls == [(3, 32, K, True), (3, 32, K, True), (1, 32, K, True)]
    _bit_equal(parts, whole)
