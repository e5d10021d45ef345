"""The port's multi-pop traversal against the JAX package's.

The index is `tests/test_torch_traverse.py`'s: built once per metric by
the JAX package, written to disk and opened by the port, so both walk
the identical forest.  The small tier's budget is lowered in both
packages (`_SMALL_POPS_MULT` 8, `_SMALL_POPS_PAD` 64), so that the
two-tier traversal, the only place multi-pop runs, serves these
2,000-item indexes.

Tolerances, as in `test_torch_traverse.py`:
- the pop loop, given the JAX package's margins: leaf logs, pops and
  candidate counts bit-equal;
- searches: ids equal tie-aware, distances rtol 1e-5 with a 1e-6
  absolute floor; a row that differs must differ in the port's own
  margins and agree on the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from arroy_tpu import search as j_search
from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch import search as t_search

from .test_torch_traverse import K, _arrays, _assert_same, _jax_margins, index  # noqa: F401
from .torch_util import query_arrays, recall
from .util import random_vectors

METRICS = ("euclidean", "cosine", "dot-product", "binary quantized cosine")


@pytest.fixture
def small_tier(monkeypatch):
    monkeypatch.delenv("ARROY_MULTIPOP", raising=False)
    for mod in (j_search, t_search):
        monkeypatch.setattr(mod, "_SMALL_POPS_MULT", 8)
        monkeypatch.setattr(mod, "_SMALL_POPS_PAD", 64)


def _jax_multipop(jdev, fn, qv, qf, pmax, q_cap, P):
    return j_search._traverse_multipop(
        jdev.metric, fn.sk, pmax, jdev.max_leaf, P, jdev.node_table, jdev.normals, jdev.aux,
        jdev.leaf_off, jdev.leaf_cnt, jdev.leaf_items,
        jnp.asarray(np.asarray(jdev.roots, np.int32)), jnp.asarray(qv), jnp.asarray(qf),
        jnp.int32(fn.sk_exact), q_cap=q_cap, l_cap=fn.l_cap, expand=False,
    )


@pytest.mark.parametrize("P", [2, 8, 16])
@pytest.mark.parametrize("metric", METRICS)
def test_multipop_loop_matches_jax(index, small_tier, metric, P):
    """Leaf logs, pops and candidate counts bit-equal to
    `_traverse_multipop_impl(..., expand=False)` at both tiers' widths."""
    jr, tr, q = index(metric)
    jdev, tdev = jr._device(), tr._device()
    qv, qn, qe, qf = query_arrays(tdev.metric, q)
    fn, route = t_search.make_search_fn(tdev, K, 300, traversal="xla", multipop=P)
    assert route == "traversal" and fn.two_tier and fn.P == P
    jm = _jax_margins(jdev, qv, qf)
    for pmax, q_cap in ((fn.pmax_small, fn.q_cap_small), (fn.pmax, fn.q_cap)):
        jlog, jpops, jn = (np.asarray(a) for a in _jax_multipop(jdev, fn, qv, qf, pmax, q_cap, P))
        log, pops, n_cand = fn.traverse(jm, pmax, q_cap, P)
        np.testing.assert_array_equal(log.numpy(), jlog)
        np.testing.assert_array_equal(pops.numpy(), jpops)
        np.testing.assert_array_equal(n_cand.numpy(), jn)
        assert (jlog[:, -1] > 0).all() and (n_cand.numpy() >= fn.sk_exact).all()


@pytest.mark.parametrize("metric", METRICS)
def test_multipop_searcher_matches_jax(index, small_tier, metric):
    jr, tr, q = index(metric)
    # the BQ metrics oversample search_k 3x (the reference's default)
    kw = dict(search_k=300 // tr.metric.default_oversampling, engine="forest", traversal="xla",
              multipop=8)
    s = tr.searcher(K, **kw)
    fn = s.device_fn
    assert s.route == "traversal" and fn.P == 8
    qv, qn, qe, qf = query_arrays(tr.metric, q)
    _assert_same(jr, jr.searcher(K, **kw)(q), s(q), fn, qv, qn, qe, qf)
    assert fn.fallbacks == 0 and fn.last_small_ok


def test_multipop_nns_and_env_match_jax(index, small_tier, monkeypatch):
    """``ARROY_MULTIPOP`` resolves ``"auto"`` in `nns()` and `searcher()` of
    both packages; the results equal the JAX package's."""
    jr, tr, q = index("euclidean")
    monkeypatch.setenv("ARROY_MULTIPOP", "8")
    fn, _ = t_search.make_search_fn(tr._device(), K, 300)
    assert fn.P == 8
    args = query_arrays(tr.metric, q)
    _assert_same(jr, jr.nns(K).search_k(300).by_vectors(q), tr.nns(K).search_k(300).by_vectors(q),
                 fn, *args)
    s = tr.searcher(K, search_k=300, engine="forest", traversal="xla")
    assert s.device_fn.P == 8
    _assert_same(jr, jr.searcher(K, search_k=300, engine="forest", traversal="xla")(q), s(q),
                 s.device_fn, *args)


def test_multipop_filtered_runs_single_pop(index, small_tier, monkeypatch):
    """A filter forces one pop a step (`arroy_tpu/search.py:997`): with
    multipop=8 the filtered searcher equals the one at P = 1 and the JAX
    package's."""
    jr, tr, q = index("euclidean")
    cand = np.random.default_rng(12).choice(2000, 700, replace=False)
    kw = dict(search_k=300, engine="forest", traversal="xla", candidates=cand)
    s8 = tr.searcher(K, multipop=8, **kw)
    assert s8.device_fn.P == 1 and s8.device_fn.filter_words is not None
    got = s8(q)
    assert got == tr.searcher(K, multipop=1, **kw)(q)
    args = query_arrays(tr.metric, q)
    _assert_same(jr, jr.searcher(K, multipop=8, **kw)(q), got, s8.device_fn, *args)
    monkeypatch.setenv("ARROY_MULTIPOP", "8")
    _assert_same(jr, jr.nns(K).search_k(300).candidates(cand).by_vectors(q),
                 tr.nns(K).search_k(300).candidates(cand).by_vectors(q), s8.device_fn, *args)


def test_multipop_full_budget_pops_one_at_a_time(index, monkeypatch):
    """Without two tiers the loop runs at the full queue width, where the
    JAX package forces one pop a step; the widths still grow by P - 1."""
    _, tr, q = index("euclidean")
    monkeypatch.delenv("ARROY_MULTIPOP", raising=False)
    s1 = tr.searcher(K, search_k=600, engine="forest", traversal="xla", rescore="exact")
    s8 = tr.searcher(K, search_k=600, engine="forest", traversal="xla", rescore="exact", multipop=8)
    f1, f8 = s1.device_fn, s8.device_fn
    assert not f8.two_tier and f8.P == 1
    assert (f8.q_cap, f8.l_cap) == (f1.q_cap + 7, f1.l_cap + 7)
    assert s8(q) == s1(q)


# ---------------------------------------------------------------------------
# tests/test_searcher.py:161-201, on the port
# ---------------------------------------------------------------------------


def _port_reader(x, n_trees):
    db = Database(device="cpu")
    w = Writer(db, 0, x.shape[1])
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=42).n_trees(n_trees).build(wtxn)
    return Reader.open(db.read(), 0, db)


def test_multipop_traversal_recall_guard(small_tier):
    """At equal search_k the multi-pop order's recall stays within 0.05 of
    the strict order's."""
    x = random_vectors(3000, 16, seed=21)
    r = _port_reader(x, 5)
    q = x[:32]
    oracle = np.array([[i for i, _ in row] for row in r.exact_by_vectors(q, 10)])

    def rec(s):
        return recall(np.array([[i for i, _ in row] for row in s(q)]), oracle)

    s1 = r.searcher(10, search_k=600, engine="forest", multipop=1)
    s8 = r.searcher(10, search_k=600, engine="forest", multipop=8)
    assert s8.device_fn.P == 8
    r1, r8 = rec(s1), rec(s8)
    assert r8 >= r1 - 0.05, (r8, r1)


def test_multipop_exhaustive_matches_single_pop(small_tier):
    """search_k >= n_items: both pop orders collect every item."""
    x = random_vectors(500, 8, seed=22)
    r = _port_reader(x, 3)
    q = x[:8]
    a = r.searcher(5, search_k=10**6, engine="forest", multipop=1, rescore="exact")(q)
    b = r.searcher(5, search_k=10**6, engine="forest", multipop=8, rescore="exact")(q)
    assert a == b


def test_multipop_auto_resolution(monkeypatch):
    monkeypatch.delenv("ARROY_MULTIPOP", raising=False)
    for n, want in ((1000, "auto"), (300_000, "auto"), (300_000, 4), (10, None), (10, 0)):
        assert t_search.resolve_multipop(n, want) == j_search.resolve_multipop(n, want)
    assert t_search.resolve_multipop(300_000, "auto") == 1
    monkeypatch.setenv("ARROY_MULTIPOP", "2")
    assert t_search.resolve_multipop(1000, "auto") == j_search.resolve_multipop(1000, "auto") == 2
