"""The port's exact engine against the JAX package's, on one state.

Each case packs one `arroy_tpu` item store with the JAX package's own
`DeviceIndex.build_np`; the JAX engine searches its `DeviceIndex.build`,
the port searches `DeviceIndex.from_numpy` of the same pack on the CPU
(where its kernel wrappers run their plain versions).  Exact search does
not depend on the forest, so the forest is empty.

Tolerances: f32 modes — ids equal tie-aware, distances rtol 1e-4 (f32
sums in another order); fused int8/bf16 — ids agree at >= 99% of
positions, distances within 1e-4 where they agree; BQ — ids equal
tie-aware, distances within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu.metrics import metric_by_name as j_metric
from arroy_tpu.models.forest import Forest
from arroy_tpu.models.items import ItemStore
from arroy_tpu.search import _exact_bq_matrix as j_bq_matrix
from arroy_tpu.search import make_exact_fn as j_make_exact_fn
from arroy_tpu_torch.device import DeviceIndex
from arroy_tpu_torch.metrics import metric_by_name as t_metric
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.ops import bq_kernels, fused_select
from arroy_tpu_torch.search import exact_batch, make_exact_fn

from .torch_util import query_arrays, recall, tie_aware_equal, to_torch


def _state(metric, m, d, seed, dead=0):
    """(JAX DeviceIndex, port DeviceIndex, corpus) over one JAX-built store."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    jm = j_metric(metric)
    store = ItemStore(jm, d)
    store.put_many(np.arange(m), x)
    for i in range(dead):  # freed slots: never returned
        store.delete(3 * i)
    if jm.has_extra:
        slots = store.slots_of(store.ids())
        norms, extras = jm.preprocess_np(store.rows()[slots])
        store.set_preprocess(norms, extras, slots)
    forest = Forest()
    jidx = JDeviceIndex.build(jm, d, store, forest)
    tidx = DeviceIndex.from_numpy(JDeviceIndex.build_np(jm, d, store, forest), t_metric(metric), d, "cpu")
    return jidx, tidx, x


def _queries(x, n, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    q = x[rng.integers(len(x), size=n)]
    return q + noise * rng.standard_normal(q.shape).astype(np.float32)


def _run_jax(fn, metric, q):
    qv, qn, qe, qf = query_arrays(j_metric(metric), q)
    ids, d = fn(jnp.asarray(qv), jnp.asarray(qn), jnp.asarray(qe), jnp.asarray(qf))
    return np.asarray(ids).astype(np.int64), np.asarray(d)


def _run_port(fn, metric, q):
    ids, d = fn(*(to_torch(a) for a in query_arrays(t_metric(metric), q)))
    return ids.numpy(), d.numpy()


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
def test_f32x1_matches_jax(metric):
    jidx, tidx, x = _state(metric, 3000, 24, seed=1, dead=5)
    q = _queries(x, 16, seed=2)
    fn, route = make_exact_fn(tidx, 10, precision="f32x1")
    assert route == "f32x1"
    ids, d = _run_port(fn, metric, q)
    jids, jd = _run_jax(j_make_exact_fn(jidx, 10, precision="f32x1"), metric, q)
    tie_aware_equal(ids, d, jids, jd, rtol=1e-4, atol=1e-6)
    assert not np.isin(ids, np.arange(0, 15, 3)).any(), "a deleted item came back"


def test_f32_two_stage_matches_jax():
    jidx, tidx, x = _state("euclidean", 2000, 16, seed=3)
    q = _queries(x, 12, seed=4)
    fn, route = make_exact_fn(tidx, 10, precision="f32")
    assert route == "f32"
    ids, d = _run_port(fn, "euclidean", q)
    jids, jd = _run_jax(j_make_exact_fn(jidx, 10, precision="f32"), "euclidean", q)
    tie_aware_equal(ids, d, jids, jd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_fused_select_matches_jax_fused(monkeypatch, metric, precision):
    # JAX serves its fused Pallas path only on opt-in; M = 16,384 makes
    # nb2 = 128 >= 32, so both packages really run the fused select
    monkeypatch.setenv("ARROY_EXACT_FUSED", "1")
    monkeypatch.setenv("ARROY_FUSED_MIN_ITEMS", "0")
    jidx, tidx, x = _state(metric, 16384, 16, seed=5, dead=7)
    q = _queries(x, 16, seed=6)
    n0 = dict(fused_select.launches)
    fn, route = make_exact_fn(tidx, 10, precision=precision)
    assert route == "fused_select"
    ids, d = _run_port(fn, metric, q)
    assert fused_select.launches == n0  # CPU tensors: the plain version ran
    jids, jd = _run_jax(j_make_exact_fn(jidx, 10, precision=precision), metric, q)
    agree = ids == jids
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(d[agree], jd[agree], rtol=1e-4, atol=1e-4)
    assert all(len(set(r)) == len(r) for r in ids.tolist()), "duplicate ids"


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_unfused_below_the_gate(precision):
    jidx, tidx, x = _state("euclidean", 1000, 16, seed=7)
    q = _queries(x, 16, seed=8)
    fn, route = make_exact_fn(tidx, 10, precision=precision)
    assert route == "unfused"
    ids, _ = _run_port(fn, "euclidean", q)
    qv, qn, qe, _ = query_arrays(t_metric("euclidean"), q)
    ref_ids, _ = exact_batch(tidx, qv, qn, qe, 10)
    assert recall(ids, ref_ids) >= 0.99


@pytest.mark.parametrize(
    "metric",
    ["binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine"],
)
def test_bq_matrix_matches_jax(metric):
    jidx, tidx, x = _state(metric, 1500, 70, seed=9, dead=4)
    q = _queries(x, 9, seed=10, noise=0.5)
    n0 = dict(bq_kernels.launches)
    fn, route = make_exact_fn(tidx, 10)
    assert route == "bq_matrix"
    ids, d = _run_port(fn, metric, q)
    assert bq_kernels.launches == n0  # CPU tensors: the plain version ran
    qv, qn, _, _ = query_arrays(j_metric(metric), q)
    jids, jd = j_bq_matrix(
        metric, 70, 10, jidx.rows, jidx.norms, jidx.slot_to_id, jidx.live,
        jnp.asarray(qv), jnp.asarray(qn), True,
    )
    tie_aware_equal(ids, d, np.asarray(jids).astype(np.int64), np.asarray(jd), rtol=0, atol=1e-6)


def test_manhattan_matches_jax():
    jidx, tidx, x = _state("manhattan", 1200, 12, seed=11)
    q = _queries(x, 8, seed=12)
    fn, route = make_exact_fn(tidx, 10)
    assert route == "exact_batch"
    ids, d = _run_port(fn, "manhattan", q)
    jids, jd = _run_jax(j_make_exact_fn(jidx, 10), "manhattan", q)
    tie_aware_equal(ids, d, jids, jd, rtol=1e-5, atol=1e-5)


def test_manhattan_past_the_matrix_budget(monkeypatch):
    """With both budgets shrunk, manhattan runs in query chunks that keep
    their own top-k (at least 3 here) and still returns the JAX ids."""
    jidx, tidx, x = _state("manhattan", 1200, 12, seed=15)
    q = _queries(x, 10, seed=16)
    monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 1)
    monkeypatch.setattr(t_search, "_PAIR_CHUNK_BYTES", 4 * 1200 * 12 * 8)
    fn, route = make_exact_fn(tidx, 10)
    assert route == "exact_batch"
    ids, d = _run_port(fn, "manhattan", q)
    jids, jd = _run_jax(j_make_exact_fn(jidx, 10), "manhattan", q)
    tie_aware_equal(ids, d, jids, jd, rtol=1e-5, atol=1e-5)


def test_exact_max_items_routes_auto_to_the_forest(tmp_path, monkeypatch):
    """``ARROY_EXACT_MAX_ITEMS`` below the corpus size sends engine="auto"
    to the forest, as the JAX package resolves it; unset, auto is exact."""
    m, d = 600, 16
    x = np.random.default_rng(17).standard_normal((m, d)).astype(np.float32)
    db = arroy_tpu.Database(str(tmp_path))
    w = arroy_tpu.Writer(db, 0, d, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        w.builder(seed=3).n_trees(3).build(wtxn)
    jr = arroy_tpu.Reader.open(db.read(), 0, db, metric="euclidean")
    tdb = arroy_tpu_torch.Database(str(tmp_path), device="cpu")
    tr = arroy_tpu_torch.Reader.open(tdb.read(), 0, tdb, metric="euclidean")
    kw = dict(search_k=300, traversal="probe", probe_trees=3, probe_block=16)
    monkeypatch.delenv("ARROY_EXACT_MAX_ITEMS", raising=False)
    assert tr.searcher(10, **kw).engine == jr.searcher(10, **kw).engine == "exact"
    monkeypatch.setenv("ARROY_EXACT_MAX_ITEMS", str(m - 1))
    s = tr.searcher(10, **kw)
    assert s.engine == jr.searcher(10, **kw).engine == "forest"
    assert s.route == "probe"
    monkeypatch.setenv("ARROY_EXACT_MAX_ITEMS", str(m))
    assert tr.searcher(10, **kw).engine == "exact"


@pytest.mark.parametrize("precision", ["f32x1", "bf16"])
def test_filtered_candidates(monkeypatch, precision):
    # the live mask is folded into the fused tables (add = -inf), so the
    # JAX fused path with the same filter is the reference for bf16
    monkeypatch.setenv("ARROY_EXACT_FUSED", "1")
    monkeypatch.setenv("ARROY_FUSED_MIN_ITEMS", "0")
    jidx, tidx, x = _state("euclidean", 16384, 16, seed=13)
    q = _queries(x, 8, seed=14)
    allowed = np.arange(0, 16384, 7)
    fn, route = make_exact_fn(tidx, 10, filter_slots=allowed, precision=precision)
    assert route == ("f32x1" if precision == "f32x1" else "fused_select")
    ids, d = _run_port(fn, "euclidean", q)
    assert np.isin(ids, allowed).all()
    jfn = j_make_exact_fn(jidx, 10, filter_slots=allowed, precision=precision)
    jids, jd = _run_jax(jfn, "euclidean", q)
    if precision == "f32x1":
        tie_aware_equal(ids, d, jids, jd, rtol=1e-4, atol=1e-6)
    else:
        agree = ids == jids
        assert agree.mean() >= 0.99
        np.testing.assert_allclose(d[agree], jd[agree], rtol=1e-4, atol=1e-4)
