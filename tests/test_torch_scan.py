"""The port's streaming exact scans and bf16-resident serving against the
JAX package's, on one state.

Both packages are forced onto their scans by the same shrunken budgets:
a 1-byte [B, M] matrix budget and a 128-item chunk floor, so a corpus of
800 items streams in six full chunks and a ragged seventh.  As in
`tests/test_torch_exact.py`, each case packs one `arroy_tpu` item store
with the JAX package's `DeviceIndex.build_np`, and the port searches
`DeviceIndex.from_numpy` of that pack on the CPU (kernel 2's wrapper
then runs its plain version).

Tolerances: f32 scans — ids equal tie-aware, distances rtol 1e-4 (f32
sums in another order); the bf16 scans of the int8/bf16 modes and the
bf16-resident engine — ids equal at >= 99% of positions, distances rtol
1e-4 where they are; BQ scans — distances bit-equal and ids equal
tie-aware (integer counts, full of ties, whose order is unspecified).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import search as j_search
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu.metrics import metric_by_name as j_metric
from arroy_tpu.models.forest import Forest as JForest
from arroy_tpu.models.items import ItemStore as JItemStore
from arroy_tpu.search import make_exact_fn as j_make_exact_fn
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.device import DeviceIndex
from arroy_tpu_torch.metrics import metric_by_name as t_metric
from arroy_tpu_torch.models.forest import Forest as TForest
from arroy_tpu_torch.models.items import ItemStore as TItemStore
from arroy_tpu_torch.search import make_exact_fn

from .test_torch_exact import _queries, _run_jax, _run_port, _state
from .torch_util import query_arrays, recall, tie_aware_equal

M, D, K = 800, 24, 10
BQ_METRICS = ["binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine"]


def _force_scan(monkeypatch, chunk=128, **more):
    for mod in (j_search, t_search):
        monkeypatch.setattr(mod, "_EXACT_DOTS_BYTES", 1)
        monkeypatch.setattr(mod, "_EXACT_SCAN_CHUNK", chunk)
        for name, value in more.items():
            monkeypatch.setattr(mod, name, value)


def _assert_mostly_equal(ids, d, jids, jd):
    agree = ids == jids
    assert agree.mean() >= 0.99, agree.mean()
    np.testing.assert_allclose(d[agree], jd[agree], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("precision", ["f32x1", "f32"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
def test_f32_scan_matches_jax(monkeypatch, metric, precision):
    jidx, tidx, x = _state(metric, M, D, seed=21, dead=5)
    q = _queries(x, 12, seed=22)
    _force_scan(monkeypatch)
    n0 = dict(t_search.scan_calls)
    fn, route = make_exact_fn(tidx, K, precision=precision)
    assert route == precision
    ids, d = _run_port(fn, metric, q)
    assert t_search.scan_calls == {**n0, "exact_scan": n0["exact_scan"] + 1}
    jids, jd = _run_jax(j_make_exact_fn(jidx, K, precision=precision), metric, q)
    tie_aware_equal(ids, d, jids, jd, rtol=1e-4, atol=1e-6)
    assert not np.isin(ids, np.arange(0, 15, 3)).any(), "a deleted item came back"


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quantized_modes_scan_bf16_rows_as_jax(monkeypatch, metric, precision):
    """Past the budget the unfused int8 and bf16 modes scan with bf16 rows,
    as the JAX package's (whose fused path is opt-in) do."""
    jidx, tidx, x = _state(metric, M, D, seed=23, dead=3)
    q = _queries(x, 12, seed=24)
    _force_scan(monkeypatch)
    n0 = t_search.scan_calls["exact_scan"]
    fn, route = make_exact_fn(tidx, K, precision=precision)
    assert route == "unfused"
    ids, d = _run_port(fn, metric, q)
    assert t_search.scan_calls["exact_scan"] == n0 + 1
    _assert_mostly_equal(ids, d, *_run_jax(j_make_exact_fn(jidx, K, precision=precision), metric, q))


#: the JAX package's two BQ scan branches (its `_BQ_DECODE_BYTES`): the
#: popcount kernel once a chunk, and a matmul on the ±1 bf16 decode; the
#: port's one scan (kernel 2 once a chunk) must equal both
JAX_BQ_BRANCHES = pytest.mark.parametrize("jax_decode_bytes", [0, 4 << 30],
                                          ids=["jax_popcount", "jax_decode"])


@JAX_BQ_BRANCHES
@pytest.mark.parametrize("metric", BQ_METRICS)
def test_bq_scan_matches_jax_and_the_matrix(monkeypatch, metric, jax_decode_bytes):
    jidx, tidx, x = _state(metric, M, 70, seed=25, dead=4)
    q = _queries(x, 9, seed=26, noise=0.5)
    fn, route = make_exact_fn(tidx, K)
    assert route == "bq_matrix"
    mids, md = _run_port(fn, metric, q)  # under the budget: the [B, M] matrix
    _force_scan(monkeypatch)
    monkeypatch.setattr(j_search, "_BQ_DECODE_BYTES", jax_decode_bytes)
    n0 = dict(t_search.scan_calls)
    ids, d = _run_port(make_exact_fn(tidx, K)[0], metric, q)
    assert t_search.scan_calls == {**n0, "bq_scan": n0["bq_scan"] + 1}
    tie_aware_equal(ids, d, mids, md, rtol=0, atol=0)
    tie_aware_equal(ids, d, *_run_jax(j_make_exact_fn(jidx, K), metric, q), rtol=0, atol=0)


@JAX_BQ_BRANCHES
def test_bq_scan_pads_past_a_narrow_chunk(monkeypatch, jax_decode_bytes):
    """Chunks of 4 items keep 4 winners each, so a top-10 returns 4
    results and 6 NaN-padded slots, as the JAX package's scan does."""
    metric = "binary quantized manhattan"
    jidx, tidx, x = _state(metric, 40, 70, seed=27)
    q = _queries(x, 5, seed=28, noise=0.5)
    _force_scan(monkeypatch, chunk=4)
    monkeypatch.setattr(j_search, "_BQ_DECODE_BYTES", jax_decode_bytes)
    ids, d = _run_port(make_exact_fn(tidx, K)[0], metric, q)
    assert ids.shape == d.shape == (5, K)
    assert np.isfinite(d[:, :4]).all() and np.isnan(d[:, 4:]).all() and (ids[:, 4:] == 0).all()
    jids, jd = _run_jax(j_make_exact_fn(jidx, K), metric, q)
    tie_aware_equal(ids, d, jids, jd, rtol=0, atol=0)


@pytest.mark.parametrize("metric,precision", [
    ("euclidean", "f32x1"), ("cosine", "bf16"), ("binary quantized euclidean", "auto"),
])
def test_filtered_scan_matches_jax(monkeypatch, metric, precision):
    jidx, tidx, x = _state(metric, M, D if metric != "binary quantized euclidean" else 70, seed=29)
    q = _queries(x, 8, seed=30, noise=0.5)
    allowed = np.arange(0, M, 3)
    _force_scan(monkeypatch)
    n0 = sum(t_search.scan_calls.values())
    ids, d = _run_port(make_exact_fn(tidx, K, filter_slots=allowed, precision=precision)[0], metric, q)
    assert sum(t_search.scan_calls.values()) == n0 + 1
    assert np.isin(ids, allowed).all()
    jids, jd = _run_jax(j_make_exact_fn(jidx, K, filter_slots=allowed, precision=precision), metric, q)
    if precision == "bf16":
        _assert_mostly_equal(ids, d, jids, jd)
    else:
        tie_aware_equal(ids, d, jids, jd, rtol=1e-4 if precision == "f32x1" else 0, atol=0)


@pytest.mark.parametrize("metric,precision,counter", [
    ("euclidean", "f32x1", "exact_scan"), ("cosine", "f32", "exact_scan"),
    ("euclidean", "int8", "exact_scan"), ("binary quantized cosine", "auto", "bq_scan"),
])
def test_one_searcher_chooses_the_matrix_or_the_scan_per_batch(monkeypatch, metric, precision, counter):
    """A budget that holds 8 queries' matrix: a batch of 8 is served by the
    matrix and a batch of 32 by the scan, from one bound searcher, with the
    same results for the 8 queries both served."""
    jidx, tidx, x = _state(metric, M, D if "binary" not in metric else 70, seed=31)
    q = _queries(x, 32, seed=32, noise=0.5)
    monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 8 * M * 4)
    monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 128)
    fn, _ = make_exact_fn(tidx, K, precision=precision)
    n0 = dict(t_search.scan_calls)
    small = _run_port(fn, metric, q[:8])
    assert t_search.scan_calls == n0
    ids, d = _run_port(fn, metric, q)
    assert t_search.scan_calls == {**n0, counter: n0[counter] + 1}
    if precision == "int8":  # int8 matrix cut against the bf16 scan
        _assert_mostly_equal(ids[:8], d[:8], *small)
    else:
        tie_aware_equal(ids[:8], d[:8], *small, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_cut_width_grows_with_the_corpus(monkeypatch, k):
    """The int8/bf16 cut keeps the JAX package's width up to `_CUT_ITEMS`
    items and doubles it as the corpus passes each power of two of that
    unit; the unfused route's cut takes it (here 2 x 32 at 300 items)."""
    base = max(t_search._next_pow2(3 * k), 32)
    for cap in (100, 1000, 262_144):
        assert t_search._cut_width(k, cap) == min(base, cap)
    assert [t_search._cut_width(k, cap) for cap in (262_145, 524_288, 524_289, 1_000_000, 2_000_000)
            ] == [2 * base, 2 * base, 4 * base, 4 * base, 8 * base]
    monkeypatch.setattr(t_search, "_CUT_ITEMS", 256)
    jidx, tidx, x = _state("euclidean", 300, D, seed=37)
    q = _queries(x, 4, seed=38)
    seen = []
    two_stage = t_search._two_stage
    monkeypatch.setattr(t_search, "_two_stage", lambda *a: seen.append(a[3]) or two_stage(*a))
    _run_port(make_exact_fn(tidx, k, precision="bf16")[0], "euclidean", q)
    assert seen == [min(2 * base, 300)]


# ---------------------------------------------------------------------------
# ARROY_SERVING_DTYPE=bf16
# ---------------------------------------------------------------------------


def _stores(metric, m=600, d=32, seed=33):
    """Equal JAX and port item stores over one seeded corpus."""
    x = np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)
    jm, tm = j_metric(metric), t_metric(metric)
    js, ts = JItemStore(jm, d), TItemStore(tm, d)
    for s in (js, ts):
        s.put_many(np.arange(m), x)
    if jm.has_extra:
        slots = js.slots_of(js.ids())
        norms, extras = jm.preprocess_np(js.rows()[slots])
        for s in (js, ts):
            s.set_preprocess(norms, extras, slots)
    return js, ts, x


def _bf16_pair(monkeypatch, metric):
    """(JAX DeviceIndex, port DeviceIndex, corpus), each built by its own
    package's `DeviceIndex.build` under ARROY_SERVING_DTYPE=bf16."""
    monkeypatch.setenv("ARROY_SERVING_DTYPE", "bf16")
    js, ts, x = _stores(metric)
    d = x.shape[1]
    return (JDeviceIndex.build(j_metric(metric), d, js, JForest()),
            DeviceIndex.build(t_metric(metric), d, ts, TForest(), "cpu"), x)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product", "manhattan"])
def test_serving_bf16_rows_equal_jax_bits(monkeypatch, metric):
    """bf16 rows with the JAX package's bits (round to nearest even), f32
    norms and extras, and 2 bytes a value in `nbytes`."""
    jidx, tidx, x = _bf16_pair(monkeypatch, metric)
    assert tidx.rows.dtype == torch.bfloat16 and jidx.rows.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tidx.rows.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jidx.rows).view(np.uint16))
    for name in ("norms", "extras"):
        t = getattr(tidx, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jidx, name)))
    monkeypatch.delenv("ARROY_SERVING_DTYPE")
    _, ts, _ = _stores(metric)
    f32 = DeviceIndex.build(t_metric(metric), x.shape[1], ts, TForest(), "cpu")
    assert f32.rows.dtype == torch.float32
    assert f32.nbytes() - tidx.nbytes() == 2 * tidx.rows.numel()


@pytest.mark.parametrize("scan", [False, True], ids=["matrix", "scan"])
@pytest.mark.parametrize("precision", ["f32x1", "f32", "bf16"])
def test_serving_bf16_exact_engine_matches_jax(monkeypatch, precision, scan):
    """The exact engine on bf16 rows against the JAX package's on its bf16
    rows (the JAX bf16 mode with its f32 cut, `ARROY_CUT_DTYPE=f32`), and
    recall against a host f32 oracle (`test_exact_engine.py`'s check)."""
    monkeypatch.setenv("ARROY_CUT_DTYPE", "f32")
    jidx, tidx, x = _bf16_pair(monkeypatch, "euclidean")
    q = x[:8] + 0.01 * np.random.default_rng(34).standard_normal((8, x.shape[1])).astype(np.float32)
    if scan:
        _force_scan(monkeypatch)
    n0 = t_search.scan_calls["exact_scan"]
    ids, d = _run_port(make_exact_fn(tidx, K, precision=precision)[0], "euclidean", q)
    assert t_search.scan_calls["exact_scan"] == n0 + scan
    _assert_mostly_equal(ids, d, *_run_jax(j_make_exact_fn(jidx, K, precision=precision), "euclidean", q))
    want = np.argsort(((x[None, :, :] - q[:, None, :]) ** 2).sum(-1), axis=1)[:, :K]
    assert recall(ids, want) >= 0.9


@pytest.mark.parametrize("rescore", ["exact", "matmul", "matmul_scan"])
def test_serving_bf16_traversal(tmp_path, monkeypatch, rescore):
    """The forest engine's traversal re-scores from bf16 rows in each of its
    modes: with a search_k past the corpus every item is a candidate, so
    it returns the exact engine's answer over the same bf16 rows (the
    matmul mode's distances come off a bf16 product, as the JAX
    package's do, so only its ids are held), and the JAX package's."""
    m, d = 600, 32
    x = np.random.default_rng(35).standard_normal((m, d)).astype(np.float32)
    db = arroy_tpu_torch.Database(str(tmp_path), device="cpu")
    w = arroy_tpu_torch.Writer(db, 0, d, metric="cosine")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m), x)
        w.builder(seed=1).n_trees(2).build(wtxn)
    monkeypatch.setenv("ARROY_SERVING_DTYPE", "bf16")
    if rescore == "matmul_scan":
        monkeypatch.setattr(t_search, "_RESCORE_MATRIX_BYTES", 1)
        monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 1)
        monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 128)
    db = arroy_tpu_torch.Database(str(tmp_path), device="cpu")
    r = arroy_tpu_torch.Reader.open(db.read(), 0, db, metric="cosine")
    s = r.searcher(K, search_k=4 * m, engine="forest", traversal="xla",
                   rescore={"exact": "exact", "matmul": "matmul"}.get(rescore, "auto"))
    assert s.route == "traversal" and s._dev.rows.dtype == torch.bfloat16
    q = x[:16] + 0.3 * np.random.default_rng(36).standard_normal((16, d)).astype(np.float32)
    assert s.device_fn.rescore_mode(len(q)) == rescore
    ids, dist = (a[:, :K].numpy() for a in s.device_fn(*s.prepare_queries(q)))
    qa = [torch.from_numpy(a) for a in query_arrays(r.metric, q)]
    eids, ed = make_exact_fn(s._dev, K, precision="f32x1")[0](*qa)
    if rescore == "matmul":
        assert recall(ids, eids.numpy()) >= 0.99
    else:
        tie_aware_equal(ids, dist, eids.numpy(), ed.numpy(), rtol=1e-4, atol=1e-6)
    jdb = arroy_tpu.Database(str(tmp_path))
    jr = arroy_tpu.Reader.open(jdb.read(), 0, jdb, metric="cosine")
    jids = np.array([[i for i, _ in row] for row in jr.searcher(K, engine="exact", precision="f32x1")(q)])
    assert recall(ids, jids) >= 0.99
