"""The port's best-first forest traversal against the JAX package's.

Each metric's index is built once with the JAX package and written to
disk; the port opens that same directory, so both packages walk the
identical forest.  Inputs are made with numpy from a seed; the queries
are fresh, noisier draws of the corpus model, not copies of items, so
that no matmul distance sits in the cancellation noise near zero.

Tolerances:
- the pop loop (plain and filtered), given the JAX package's own margins,
  and the leaf-log expansion: bit-equal (the same integer state);
- searches: ids equal tie-aware, distances rtol 1e-5 with an absolute
  floor of 1e-6 (the f32 cancellation in cosine's ``1 - cos``).  The
  port's margins come from its own f32 matmul and may differ from the
  JAX package's in the last bit; a query whose result differs is run
  again on the JAX package's margins, where it must be equal, and its
  own margins must differ, which shows that the last bit was the cause.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import search as j_search
from arroy_tpu_torch import search as t_search

from .torch_util import query_arrays, tie_aware_equal

M, DIM, TREES, K, B = 2000, 32, 6, 10, 48
METRICS = (
    "euclidean", "cosine", "dot-product", "manhattan",
    "binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine",
)


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((16, DIM)).astype(np.float32)
    n = M + B
    pa, pb = rng.integers(16, size=n), rng.integers(16, size=n)
    mask = rng.random((n, DIM)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    x[:M] += 0.05 * rng.standard_normal((M, DIM)).astype(np.float32)
    # queries 10x noisier: their nearest items lie ~2.5 away, where the
    # matmul re-score's f32 cancellation (~1e-5 on |x|² ~ 60) is far
    # below the tolerance
    x[M:] += 0.5 * rng.standard_normal((B, DIM)).astype(np.float32)
    return x[:M], x[M:]


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


def _arrays(results):
    ids = np.zeros((len(results), K), np.int64)
    d = np.full((len(results), K), np.nan)
    for i, row in enumerate(results):
        ids[i, : len(row)] = [j for j, _ in row]
        d[i, : len(row)] = [v for _, v in row]
    return ids, d


def _row_equal(jids, jd, tids, td):
    try:
        np.testing.assert_array_equal(np.isnan(jd), np.isnan(td))
        tie_aware_equal(tids[None], np.nan_to_num(td)[None], jids[None], np.nan_to_num(jd)[None],
                        rtol=1e-5, atol=1e-6)
    except AssertionError:
        return False
    return True


def _jax_margins(jdev, qv, qf):
    m = jax.jit(jdev.metric.margin_matrix)(jdev.normals, jdev.aux, jnp.asarray(qv), jnp.asarray(qf))
    return torch.from_numpy(np.array(m))


def _assert_same(jr, jres, tres, fn, qv, qn, qe, qf):
    """Tie-aware equality; a differing row must be due to the last bit of
    the port's margins (see the module docstring)."""
    jids, jd = _arrays(jres)
    tids, td = _arrays(tres)
    bad = [i for i in range(len(jids)) if not _row_equal(jids[i], jd[i], tids[i], td[i])]
    if not bad:
        return
    rows = np.asarray(bad)
    qv_t, qn_t, qe_t, qf_t = (torch.from_numpy(np.ascontiguousarray(a[rows]).view(
        np.int32 if a.dtype == np.uint32 else a.dtype)) for a in (qv, qn, qe, qf))
    jm = _jax_margins(jr._device(), qv[rows], qf[rows])
    own = fn.margins(qv_t, qf_t)
    for j, i in enumerate(bad):
        assert not torch.equal(own[j], jm[j]), f"query {i} differs from JAX with equal margins"
    ids, d = fn.run(jm, qv_t, qn_t, qe_t)
    ids, d = ids[:, :K].numpy(), d[:, :K].numpy()
    for j, i in enumerate(bad):
        assert _row_equal(jids[i], jd[i], ids[j], d[j]), f"query {i} differs on JAX's margins"


def _jax_geometry(jdev, count, search_k, selectivity=1.0):
    """make_search_fn's traversal geometry, from the JAX package's functions."""
    csr_total = max(int(jdev.leaf_items.shape[0]) - jdev.max_leaf, 1)
    sk_exact = min(max(search_k, count), csr_total)
    sk = j_search._next_pow2(sk_exact)
    pmax = j_search.pops_budget(jdev, sk_exact, False, selectivity)
    t = max(len(jdev.roots), 1)
    mean_leaf = float(jdev.leaf_cum_np[-1]) / len(jdev.leaf_cum_np)
    pmax_small = min(pmax, j_search._SMALL_POPS_MULT * int(np.ceil(sk_exact / mean_leaf))
                     + j_search._SMALL_POPS_PAD)
    return dict(
        sk_exact=sk_exact, sk=sk, pmax=pmax, pmax_small=pmax_small,
        two_tier=selectivity >= 1.0 and pmax_small < pmax // 2,
        q_cap=t + min(pmax, jdev.n_splits) + 1,
        q_cap_small=t + min(pmax_small, jdev.n_splits) + 1,
        l_cap=min(min(sk, pmax), jdev.max_leaf_pops(sk)) + 1,
    )


# ---------------------------------------------------------------------------
# (a) budgets and geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_budgets_match_jax(index, metric):
    jr, tr, _ = index(metric)
    jdev, tdev = jr._device(), tr._device()
    for search_k in (30, 600, 5000):
        assert t_search.pops_budget(tdev, search_k, False) == j_search.pops_budget(jdev, search_k, False)
        assert t_search.pops_budget(tdev, search_k, False, 0.3) == j_search.pops_budget(jdev, search_k, False, 0.3)
        assert t_search.pops_budget(tdev, search_k, True) == j_search.pops_budget(jdev, search_k, True)
        assert tdev.max_leaf_pops(search_k) == jdev.max_leaf_pops(search_k)
        fn, route = t_search.make_search_fn(tdev, K, search_k, traversal="xla")
        assert route == "traversal"
        want = _jax_geometry(jdev, K, search_k)
        assert {key: getattr(fn, key) for key in want} == want
    sd = tdev.metric.storage_dim(DIM)
    assert tdev.estimate_nbytes(tdev.metric, DIM, M, TREES) == jdev.estimate_nbytes(jdev.metric, DIM, M, TREES)
    assert sd == jdev.metric.storage_dim(DIM)
    # slot_to_id is int64 in the port, uint32 in the JAX package
    assert tdev.nbytes() == jdev.nbytes() + 4 * tdev.cap


def test_scan_chunk_and_multipop_match_jax(monkeypatch):
    for b in (1, 48, 256, 2048):
        assert t_search._scan_chunk(b) == j_search._scan_chunk(b)
    monkeypatch.delenv("ARROY_MULTIPOP", raising=False)
    for want in ("auto", None, 1, 4):
        assert t_search.resolve_multipop(want) == j_search.resolve_multipop(M, want)
    monkeypatch.setenv("ARROY_MULTIPOP", "3")
    assert t_search.resolve_multipop("auto") == j_search.resolve_multipop(M, "auto") == 3


# ---------------------------------------------------------------------------
# (b)-(d) the pop loop and the expansion, given the JAX package's margins
# ---------------------------------------------------------------------------


def _loop_inputs(index, metric, search_k, filter_slots=None):
    jr, tr, q = index(metric)
    jdev, tdev = jr._device(), tr._device()
    qv, qn, qe, qf = query_arrays(tdev.metric, q)
    fn, route = t_search.make_search_fn(tdev, K, search_k, filter_slots, traversal="xla")
    assert route == "traversal"
    return jdev, tdev, fn, (qv, qf), _jax_margins(jdev, qv, qf)


def _jax_loop(jdev, fn, qv, qf, filter_words=None, expand=False):
    return j_search._traverse_batch(
        jdev.metric, fn.sk, fn.pmax, jdev.max_leaf, filter_words is not None,
        jdev.node_table, jdev.normals, jdev.aux, jdev.leaf_off, jdev.leaf_cnt,
        jdev.leaf_items, jnp.asarray(np.asarray(jdev.roots, np.int32)),
        jnp.asarray(qv), jnp.asarray(qf),
        jnp.zeros(1, jnp.uint32) if filter_words is None else jnp.asarray(filter_words),
        jnp.int32(fn.sk_exact), q_cap=fn.q_cap, l_cap=fn.l_cap, expand=expand,
    )


LOOP_CASES = [
    ("euclidean", 600), ("cosine", 600), ("dot-product", 600), ("manhattan", 600),
    ("binary quantized cosine", 600), ("euclidean", 100),
]


@pytest.mark.parametrize("metric,search_k", LOOP_CASES)
def test_loop_matches_jax(index, metric, search_k):
    """The leaf logs (all of them: rows past the count are 0 in both),
    pops and candidate counts, bit-equal."""
    jdev, _, fn, (qv, qf), jm = _loop_inputs(index, metric, search_k)
    jlog, jpops, jn = (np.asarray(a) for a in _jax_loop(jdev, fn, qv, qf))
    log, pops, n_cand = fn.traverse(jm, fn.pmax, fn.q_cap)
    assert (jlog[:, -1] > 0).all() and (jpops < fn.pmax).all()
    np.testing.assert_array_equal(log.numpy(), jlog)
    np.testing.assert_array_equal(pops.numpy(), jpops)
    np.testing.assert_array_equal(n_cand.numpy(), jn)
    assert (n_cand.numpy() >= fn.sk_exact).all()


@pytest.mark.parametrize("metric,search_k", LOOP_CASES)
def test_expand_matches_jax(index, metric, search_k):
    jdev, tdev, fn, (qv, qf), jm = _loop_inputs(index, metric, search_k)
    jlog = _jax_loop(jdev, fn, qv, qf)[0]
    want = np.asarray(jax.vmap(
        lambda lg: j_search._expand_one_log(lg, jdev.leaf_off, jdev.leaf_cnt, jdev.leaf_items, fn.cap)
    )(jlog))
    got = t_search._expand_log(torch.from_numpy(np.asarray(jlog, np.int64)), tdev.leaf_off,
                               tdev.leaf_cnt, tdev.leaf_items, fn.cap)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fn.expand(fn.traverse(jm, fn.pmax, fn.q_cap)[0]).numpy(), want)


@pytest.mark.parametrize("metric", ["euclidean", "dot-product"])
def test_filtered_loop_matches_jax(index, metric):
    """A filter of 900 items, more than search_k: the [B, cap] compacted
    candidates, pops and counts, bit-equal (bit 31 of a word included)."""
    filt = np.sort(np.random.default_rng(11).choice(M, 900, replace=False))
    filt = np.union1d(filt, [31, 63, 1023])
    jdev, tdev, fn, (qv, qf), jm = _loop_inputs(index, metric, 300, filt)
    assert not fn.two_tier
    words = fn.filter_words.numpy().view(np.uint32)
    jc, jpops, jn = (np.asarray(a) for a in _jax_loop(jdev, fn, qv, qf, words, expand=True))
    cand, pops, n_cand = fn.traverse(jm, fn.pmax, fn.q_cap)
    np.testing.assert_array_equal(cand.numpy(), jc)
    np.testing.assert_array_equal(pops.numpy(), jpops)
    np.testing.assert_array_equal(n_cand.numpy(), jn)
    got = cand.numpy()
    assert set(got[got >= 0].tolist()) <= set(filt.tolist())


# ---------------------------------------------------------------------------
# (e) end to end: Searcher(engine="forest", traversal="xla") and nns()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rescore", ["exact", "auto"])
@pytest.mark.parametrize("metric", METRICS)
def test_searcher_matches_jax(index, metric, rescore):
    jr, tr, q = index(metric)
    kw = dict(search_k=200, engine="forest", traversal="xla", rescore=rescore)
    s = tr.searcher(K, **kw)
    assert s.engine == "forest" and s.route == "traversal"
    b = len(q)
    want_mode = "exact" if rescore == "exact" or tr.metric.binary or metric == "manhattan" else "matmul"
    assert s.device_fn.rescore_mode(b) == want_mode
    qv, qn, qe, qf = query_arrays(tr.metric, q)
    _assert_same(jr, jr.searcher(K, **kw)(q), s(q), s.device_fn, qv, qn, qe, qf)


@pytest.mark.parametrize("metric", METRICS)
def test_nns_matches_jax(index, metric):
    """by_vectors, by_items (with an absent id), by_item and by_vector."""
    jr, tr, q = index(metric)
    sk = 200
    fn, _ = t_search.make_search_fn(tr._device(), K, sk * tr.metric.default_oversampling)
    qv, qn, qe, qf = query_arrays(tr.metric, q)
    _assert_same(jr, jr.nns(K).search_k(sk).by_vectors(q), tr.nns(K).search_k(sk).by_vectors(q),
                 fn, qv, qn, qe, qf)
    items = np.asarray([5, 10**6, 77, 1999, 400])
    jres, tres = jr.nns(K).search_k(sk).by_items(items), tr.nns(K).search_k(sk).by_items(items)
    assert jres[1] is None and tres[1] is None
    st = tr._state.store
    slots = st.slots_of(items[[0, 2, 3, 4]].astype(np.uint32))
    qe_i = st.extras()[slots]
    qf_i = qe_i if tr.metric.has_extra else np.ones(len(slots), np.float32)
    _assert_same(jr, [r for r in jres if r is not None], [r for r in tres if r is not None],
                 fn, st.rows()[slots], st.norms()[slots], qe_i, qf_i)
    if metric in ("euclidean", "cosine", "manhattan"):
        assert tres[0][0][0] == 5  # an item is its own nearest neighbour
    _assert_same(jr, [jr.nns(K).search_k(sk).by_item(77)], [tr.nns(K).search_k(sk).by_item(77)],
                 fn, st.rows()[slots[1:2]], st.norms()[slots[1:2]], qe_i[1:2], qf_i[1:2])
    assert tr.nns(K).by_item(10**6) is None
    _assert_same(jr, [jr.nns(K).search_k(sk).by_vector(q[3])], [tr.nns(K).search_k(sk).by_vector(q[3])],
                 fn, *(a[3:4] for a in (qv, qn, qe, qf)))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_filtered_searcher_matches_jax(index, metric):
    """A candidate filter larger than search_k runs the filtered loop."""
    jr, tr, q = index(metric)
    cand = np.random.default_rng(12).choice(M, 700, replace=False)
    kw = dict(search_k=300, engine="forest", traversal="xla", candidates=cand)
    s = tr.searcher(K, **kw)
    assert s.route == "traversal" and s.device_fn.filter_words is not None
    got = s(q)
    _assert_same(jr, jr.searcher(K, **kw)(q), got, s.device_fn, *query_arrays(tr.metric, q))
    assert set(i for row in got for i, _ in row) <= set(cand.tolist())
    _assert_same(jr, jr.nns(K).search_k(300).candidates(cand).by_vectors(q),
                 tr.nns(K).search_k(300).candidates(cand).by_vectors(q),
                 s.device_fn, *query_arrays(tr.metric, q))


# ---------------------------------------------------------------------------
# (f) two tiers, (g) the streamed matmul re-score, (h) nns() and multipop
# ---------------------------------------------------------------------------


def test_two_tier_fallback_matches_single_tier(index, monkeypatch):
    """A small tier of one pop truncates every query: the full-budget
    re-run must give the single tier's results."""
    _, tr, q = index("euclidean")
    kw = dict(search_k=600, engine="forest", traversal="xla", rescore="exact")
    single = tr.searcher(K, **kw)
    assert not single.device_fn.two_tier
    want = single(q)
    monkeypatch.setattr(t_search, "_SMALL_POPS_MULT", 0)
    monkeypatch.setattr(t_search, "_SMALL_POPS_PAD", 1)
    s = tr.searcher(K, **kw)
    fn = s.device_fn
    assert fn.two_tier and fn.pmax_small == 1
    assert s(q) == want
    assert fn.fallbacks == 1 and fn.last_small_ok is False
    assert int(fn.last_pops.max()) < fn.pmax


def test_two_tier_small_path_matches_single_tier(index, monkeypatch):
    """When the small tier suffices, its results equal the single tier's."""
    _, tr, q = index("euclidean")
    kw = dict(search_k=100, engine="forest", traversal="xla", rescore="exact")
    single = tr.searcher(K, **kw)
    assert not single.device_fn.two_tier
    want = single(q)
    monkeypatch.setattr(t_search, "_SMALL_POPS_MULT", 8)
    monkeypatch.setattr(t_search, "_SMALL_POPS_PAD", 64)
    s = tr.searcher(K, **kw)
    fn = s.device_fn
    assert fn.two_tier and fn.q_cap_small < fn.q_cap
    assert s(q) == want
    assert fn.fallbacks == 0 and fn.last_small_ok is True


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
def test_matmul_scan_matches_jax(index, metric, monkeypatch):
    """Both packages forced onto the streamed re-score: 1-byte matrix
    budget, 128-item chunk floor, and a score budget that stops the chunk
    at 512 items (4 chunks of the 2,000-item corpus)."""
    jr, tr, q = index(metric)
    for mod in (j_search, t_search):
        monkeypatch.setattr(mod, "_RESCORE_MATRIX_BYTES", 1)
        monkeypatch.setattr(mod, "_EXACT_SCAN_CHUNK", 128)
        monkeypatch.setattr(mod, "_EXACT_DOTS_BYTES", 256 << 10)
    assert t_search._scan_chunk(len(q)) == 512
    kw = dict(search_k=200, engine="forest", traversal="xla", rescore="auto")
    s = tr.searcher(K, **kw)
    assert s.device_fn.rescore_mode(len(q)) == "matmul_scan"
    assert j_search.rescore_mode(jr.metric, len(q), s.device_fn.cap, M) == "matmul_scan"
    _assert_same(jr, jr.searcher(K, **kw)(q), s(q), s.device_fn, *query_arrays(tr.metric, q))
    assert s.device_fn._scan_aux is not None  # the streamed re-score ran


def test_nns_traverses_at_any_size(index, monkeypatch):
    """nns() has no host snapshot to build probe tables from, so it walks
    the forest even where a Searcher would probe."""
    jr, tr, q = index("euclidean")
    monkeypatch.delenv("ARROY_TRAVERSAL", raising=False)
    monkeypatch.setattr(t_search, "_PROBE_MIN_ITEMS", M // 2)
    assert tr.searcher(K, search_k=600, engine="forest", probe_trees=4, probe_block=16).route == "probe"
    fn, route = t_search.make_search_fn(tr._device(), K, 600)
    assert route == "traversal"
    _assert_same(jr, jr.nns(K).search_k(600).by_vectors(q), tr.nns(K).search_k(600).by_vectors(q),
                 fn, *query_arrays(tr.metric, q))


def test_multipop_raises(index, monkeypatch):
    _, tr, q = index("euclidean")
    monkeypatch.delenv("ARROY_MULTIPOP", raising=False)
    kw = dict(search_k=600, engine="forest", traversal="xla")
    with pytest.raises(NotImplementedError, match="multipop"):
        tr.searcher(K, multipop=4, **kw)
    assert tr.searcher(K, multipop=1, **kw).route == "traversal"
    monkeypatch.setenv("ARROY_MULTIPOP", "4")
    with pytest.raises(NotImplementedError, match="multipop"):
        tr.searcher(K, **kw)
    with pytest.raises(NotImplementedError, match="multipop"):
        tr.nns(K).search_k(600).by_vectors(q)
