"""Kernel 5's plain versions (`ops/rescore`: the exact engine's stage 2,
key cut → candidate gather → exact f32 re-score → top-k) on the CPU.

* Against the JAX package on identical keys: the JAX package's own fused
  select (Pallas, interpret mode) on its own `_fused_tables` gives the
  keys and positions; `cut_rescore_reference` takes them and must answer
  as the JAX package's `_exact_fused` on the same state: ids tie-aware
  equal, distances rtol 1e-5 (f32 sums in another order).
* Against a float64 oracle (numpy; the cut keeps the c largest keys, ties
  by the lowest position; the top-k is a stable sort by distance): every
  metric the kernel serves, f32 and bf16 rows, d = 5, 33 and 768, ties at
  the c-th key, dead keys and dead slots, fewer valid candidates than k,
  raw distances; and the searchers' routes at count = 1000 (the f32x1
  matrix, the f32 two-stage, the streamed scan) and at count >= cap / 4
  (f32x1 re-scores the whole corpus): ids tie-aware equal, distances
  rtol 1e-5, atol 1e-6, or for a dot product that cancels 1e-7 of its
  Σ|x·q| (the f32 rounding of its terms, which float64 does not have).
* The sharded f32x1 stage (`ShardedExactIndex`) reaches kernel 5's
  wrapper and equals the single-device f32x1 engine.
* An f32 search leaves the caller's TF32 setting as it found it.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`,
marker `gpu`); here each wrapper must take its plain version on CPU
tensors and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arroy_tpu import search as j_search
from arroy_tpu.metrics import metric_by_name as j_metric
from arroy_tpu.ops.pallas_exact import fused_block_select as j_fused_block_select
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.metrics import metric_by_name as t_metric
from arroy_tpu_torch.ops import rescore as rs
from arroy_tpu_torch.ops.fused_select import DEAD_KEY_MAX
from arroy_tpu_torch.parallel.mesh import ShardedExactIndex, make_mesh
from arroy_tpu_torch.search import make_exact_fn

from .test_torch_exact import _queries, _run_port, _state
from .torch_util import query_arrays, tie_aware_equal, to_torch

METRICS = ("euclidean", "cosine", "dot-product")
TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the JAX package on identical keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("int8", [True, False])
def test_cut_matches_jax_exact_fused_on_identical_keys(metric, int8):
    # 16,384 items: 128 block winners, cut to c = 32
    jidx, tidx, x = _state(metric, 16384, 16, seed=11, dead=9)
    q = _queries(x, 12, seed=12)
    k, c = 10, t_search._cut_width(10, jidx.cap)
    jm = j_metric(metric)
    xq, mult, add, p2s = j_search._fused_tables(jm, jidx.rows, jidx.norms, jidx.live, int8)
    qv, qn, qe, qf = (jnp.asarray(a) for a in query_arrays(jm, q))
    if int8:  # the JAX package's query quantization (`_exact_fused_impl`)
        qmax = jnp.max(jnp.abs(qv), axis=1)
        qsc = jnp.where(qmax > 0, qmax / 127.0, 1.0)
        qq = jnp.clip(jnp.round(qv / qsc[:, None]), -127, 127).astype(jnp.int8)
    else:
        qsc = jnp.ones(qv.shape[0], jnp.float32)
        qq = qv.astype(jnp.bfloat16)
    qq = jnp.concatenate([qq, jnp.zeros((qq.shape[0], xq.shape[1] - qq.shape[1]), qq.dtype)], axis=1)
    keys, idxp = j_fused_block_select(qq, xq, qsc, mult, add, interpret=True)
    assert keys.shape[1] > c
    jids, jd = j_search._exact_fused(
        jm, 16, k, c, int8, True, jidx.rows, jidx.norms, jidx.extras, jidx.slot_to_id, jidx.live,
        xq, mult, add, p2s, qv, qn, qe, qf)
    n0 = dict(rs.launches)
    ids, d = rs.cut_rescore(
        tidx.metric, 16, k, c, to_torch(np.asarray(keys)), to_torch(np.asarray(idxp)),
        torch.from_numpy(np.asarray(p2s).astype(np.int64)), tidx.live, tidx.rows, tidx.norms,
        tidx.extras, tidx.slot_to_id, *(to_torch(np.asarray(a)) for a in (qv, qn, qe)))
    assert rs.launches == n0  # CPU tensors: the plain version ran
    tie_aware_equal(ids.numpy(), d.numpy(), np.asarray(jids).astype(np.int64), np.asarray(jd),
                    **TOL)


# ---------------------------------------------------------------------------
# a float64 oracle
# ---------------------------------------------------------------------------


def _oracle_topk(metric, k, cand, valid, rows, norms, slot_to_id, qv, qn, normalize=True):
    """Exact distances in float64 from the rows as stored (bf16 values
    exactly), inf where not valid; the k smallest, ties by column.
    Returns (ids, d, atol): an f32 dot product that cancels carries the
    rounding of its terms, so the absolute tolerance is 1e-7 of the
    largest Σ|x·q| (cosine: over |x|·|q|), 1e-6 for euclidean (no
    cancellation; rtol covers it)."""
    x = rows.double().numpy()[cand]  # [B, c, d]
    q = qv.double().numpy()[:, None, :]
    atol = 1e-6
    if metric == "euclidean":
        d = ((x - q) ** 2).sum(-1)
    else:
        pq = (x * q).sum(-1)
        mag = np.abs(x * q).sum(-1)
        if metric == "dot-product":
            d = -pq
        else:
            pnqn = norms.numpy()[cand] * qn.numpy()[:, None]
            ok = pnqn > np.finfo(np.float32).eps
            d = np.where(ok, (1.0 - np.clip(pq / np.where(ok, pnqn, 1.0), -1, 1)) / 2, 0.0)
            mag = np.where(ok, mag / np.where(ok, pnqn, 1.0), 0.0)
        atol = max(atol, 1e-7 * float(mag.max()))
    d = np.where(valid, d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    out = np.take_along_axis(d, order, 1)
    ids = slot_to_id.numpy()[np.take_along_axis(cand, order, 1)]
    if normalize:
        norm = {"euclidean": np.sqrt(np.maximum(out, 0)), "cosine": out, "dot-product": -out}
        out = np.where(out < np.inf, norm[metric], np.nan)
    return ids, out, atol


def _agree(ids, d, wids, wd, atol):
    """Tie-aware equality at rtol 1e-5; NaN and +inf at the same places,
    where the id (a slot with no valid candidate) is unspecified."""
    np.testing.assert_array_equal(np.isnan(d), np.isnan(wd))
    np.testing.assert_array_equal(np.isinf(d), np.isinf(wd))
    d, wd = (np.where(np.isinf(a), np.nan, a) for a in (d, wd))
    tie_aware_equal(ids, d, wids, wd, rtol=1e-5, atol=atol)


def _oracle_cut(c, keys, idxp, p2s, live):
    """The c largest keys of each row, ties by the lowest position, in
    descending order: (candidate slots, validity)."""
    keys, idxp = keys.numpy().astype(np.int64), idxp.numpy()
    pos = np.broadcast_to(np.arange(keys.shape[1]), keys.shape)
    order = np.lexsort((pos, -keys))[:, :c]
    selk = np.take_along_axis(keys, order, 1)
    cand = p2s.numpy()[np.take_along_axis(idxp, order, 1)]
    return cand, (selk > DEAD_KEY_MAX) & live.numpy()[cand]


def _inputs(metric, b, cap, d, dtype, live_share, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, d)).astype(np.float32)
    q = x[rng.integers(cap, size=b)] + 0.3 * rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x[3] = 0.0  # a zero row: |x|·|q| under f32 epsilon
    rows = torch.from_numpy(x)
    if dtype == "bf16":
        rows = rows.to(torch.bfloat16)
    norms = torch.from_numpy(np.linalg.norm(rows.double().numpy(), axis=1).astype(np.float32))
    return dict(
        rows=rows, norms=norms, extras=torch.zeros(cap),
        slot_to_id=torch.from_numpy(rng.permutation(cap).astype(np.int64) * 5 + 3),
        live=torch.from_numpy(rng.random(cap) < live_share), qv=torch.from_numpy(q),
        qn=torch.from_numpy(np.linalg.norm(q, axis=1).astype(np.float32)), qe=torch.zeros(b),
    ), rng


def _stage_args(s):
    return (s["rows"], s["norms"], s["extras"], s["slot_to_id"], s["qv"], s["qn"], s["qe"])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [5, 33, 768])
def test_cut_rescore_matches_float64(metric, dtype, d):
    """Dead keys (a third, and one query all dead), dead slots (a quarter
    live, so some queries keep fewer than k valid candidates: NaN past
    them), runs of 8 equal keys sharing one slot (so the c-th key is tied
    and every choice among the ties gives the same candidates), raw
    distances too."""
    b, cap, n2, k, c = 24, 600, 256, 10, 32
    s, rng = _inputs(metric, b, cap, d, dtype, 0.25, seed=d)
    p2s = np.zeros(768, np.int64)
    p2s[:cap] = rng.permutation(cap)
    idxp = np.tile((np.arange(n2) * 151) % 768, (b, 1))
    run = (np.arange(n2) // 8) * 8
    p2s[idxp[0]] = p2s[idxp[0, run]]
    keys = rng.integers(DEAD_KEY_MAX + 1, 2**31, size=(b, n2))
    keys[rng.random((b, n2)) < 0.3] = DEAD_KEY_MAX
    keys = keys[:, run]
    keys[idxp >= cap] = DEAD_KEY_MAX
    keys[-1] = DEAD_KEY_MAX
    keys, idxp, p2s = (torch.from_numpy(a) for a in (keys.astype(np.int32),
                                                       idxp.astype(np.int32), p2s))
    cand, valid = _oracle_cut(c, keys, idxp, p2s, s["live"])
    assert (valid.sum(1) < k).any() and not valid[-1].any()
    for normalize in (True, False):
        ids, dist = rs.cut_rescore(t_metric(metric), d, k, c, keys, idxp, p2s, s["live"],
                                   *_stage_args(s), normalize=normalize)
        wids, wd, atol = _oracle_topk(metric, k, cand, valid, s["rows"], s["norms"],
                                      s["slot_to_id"], s["qv"], s["qn"], normalize)
        _agree(ids.numpy(), dist.numpy(), wids, wd, atol)
    assert np.isinf(dist.numpy()[-1]).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,k", [(40, 10), (128, 1), (700, 100)])
def test_rescore_topk_matches_float64(metric, dtype, c, k):
    b, cap, d = 16, 1000, 33
    s, rng = _inputs(metric, b, cap, d, dtype, 0.9, seed=c + k)
    cand = np.stack([rng.choice(cap, c, replace=False) for _ in range(b)])
    valid = s["live"].numpy()[cand] & (rng.random((b, c)) < 0.9)
    valid[-1] = False
    n0 = dict(rs.launches)
    for normalize in (True, False):
        ids, dist = rs.rescore_topk(t_metric(metric), d, k, torch.from_numpy(cand),
                                    torch.from_numpy(valid), *_stage_args(s), normalize=normalize)
        wids, wd, atol = _oracle_topk(metric, k, cand, valid, s["rows"], s["norms"],
                                      s["slot_to_id"], s["qv"], s["qn"], normalize)
        _agree(ids.numpy(), dist.numpy(), wids, wd, atol)
    assert rs.launches == n0


def _brute_force(idx, q, k):
    """float64 top-k euclidean distances over an index's live rows → (ids, d)."""
    x = idx.rows.double().numpy()
    d = np.sqrt(((x[None] - q[:, None].astype(np.float64)) ** 2).sum(-1))
    d[:, ~idx.live.numpy()] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx.slot_to_id.numpy()[order], np.take_along_axis(d, order, 1)


@pytest.mark.parametrize("route", ["f32x1", "f32", "scan"])
@pytest.mark.parametrize("m,count", [(10_000, 1000), (3000, 800)])
def test_routes_at_a_large_count(monkeypatch, route, m, count):
    """count = 1000 (the f32 cut keeps next_pow2(8k) = 8,192, the scan a
    chunk's 1,024, f32x1 4k) and count = 800 of 3,000 items (f32x1's cut is
    the whole corpus), each route through `rescore_topk` once, against a
    float64 brute force."""
    _, tidx, x = _state("euclidean", m, 16, seed=m, dead=20)
    q = _queries(x, 6, seed=m + 1)
    if route == "scan":
        monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 1)
        monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 1024)
    seen = []
    kernel = t_search.rescore_topk
    monkeypatch.setattr(t_search, "rescore_topk", lambda *a, **kw: seen.append(a[3].shape[1])
                        or kernel(*a, **kw))
    fn, got_route = make_exact_fn(tidx, count, precision="f32x1" if route == "scan" else route)
    assert got_route == ("f32x1" if route == "scan" else route)
    n0 = t_search.scan_calls["exact_scan"]
    ids, d = _run_port(fn, "euclidean", q)
    assert t_search.scan_calls["exact_scan"] == n0 + (route == "scan")
    np2 = t_search._next_pow2(8 * count)
    c = {"f32x1": 4 * count, "f32": np2, "scan": min(np2, 1024)}[route]
    assert seen == [min(c, tidx.cap)]
    assert route != "f32x1" or m > 4 * count or seen == [tidx.cap]
    tie_aware_equal(ids, d, *_brute_force(tidx, q, count), **TOL)


# ---------------------------------------------------------------------------
# the sharded f32x1 stage, and the TF32 setting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_f32x1_stage_goes_through_kernel5(monkeypatch, metric):
    x = np.random.default_rng(4).standard_normal((1001, 24)).astype(np.float32)
    q = x[:7] + 0.05
    seen = []
    kernel = t_search.rescore_topk
    monkeypatch.setattr(t_search, "rescore_topk",
                        lambda *a, **kw: seen.append(a[12:] or kw) or kernel(*a, **kw))
    ids, d = ShardedExactIndex(make_mesh(4, device="cpu"), x, metric=metric).search(q, 10)
    assert seen == [(False,)] * 4  # each shard's raw distances go to the merge
    jidx, tidx, _ = _state(metric, 1001, 24, seed=4)
    fn, _ = make_exact_fn(tidx, 10, precision="f32x1")
    tie_aware_equal(ids, d, *_run_port(fn, metric, q), **TOL)


def test_f32_search_keeps_the_callers_tf32_setting():
    """The f32 product runs in full f32, and the process-wide TF32 switch
    is as the caller left it afterwards."""
    _, tidx, x = _state("euclidean", 500, 16, seed=9)
    fn, _ = make_exact_fn(tidx, 10, precision="f32x1")
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            _run_port(fn, "euclidean", _queries(x, 4, seed=10))
            assert flags.allow_tf32 is setting
    finally:
        flags.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the unfused route's corpus copies
# ---------------------------------------------------------------------------


def _unfused_as_before(tidx, k, int8, q):
    """The unfused route as it was before its copies were narrowed: the
    int8 rows and queries as float64 (an exact product), the bf16 rows as
    their f32 values."""
    metric = tidx.metric
    qv, qn, qe, _ = (to_torch(a) for a in query_arrays(metric, q))
    rf = tidx.rows.float()
    if int8:
        mx = torch.amax(torch.abs(rf), dim=1)
        iscale = torch.where(mx > 0, mx / 127.0, 1.0)
        rows_q = torch.clamp(torch.round(rf / iscale[:, None]), -127, 127).double()
        qmax = torch.amax(torch.abs(qv), dim=1)
        qsc = torch.where(qmax > 0, qmax / 127.0, 1.0)
        qi8 = torch.clamp(torch.round(qv / qsc[:, None]), -127, 127)
        doti = (qi8.double() @ rows_q.T).to(torch.int32)
        dots = doti.to(torch.float32) * (qsc[:, None] * iscale[None, :])
    else:
        dots = t_search._f32_matmul(qv.to(torch.bfloat16).float(), rf.to(torch.bfloat16).float())
    score = t_search._score(metric, dots, t_search._row_sq(tidx.rows), tidx.norms)
    ids, d = t_search._two_stage(
        metric, tidx.dims, k, t_search._cut_width(k, tidx.cap), score, tidx.rows, tidx.norms,
        tidx.extras, tidx.slot_to_id, tidx.live, qv, qn, qe)
    return ids.numpy(), d.numpy()


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_unfused_copies_keep_their_width(precision):
    """The unfused route caches int8 rows (padded to multiples of 8 rows and
    columns, with f32 scales) or bf16 rows, never a float64 or f32 copy,
    and answers bit for bit as the float64 / f32 formula did: the int8 dots
    are exact either way, and the CPU's bf16 product takes the same f32
    values.  1,001 rows of 20 (off the int8 GEMM's multiples of 8), 5
    queries (under its 17 rows), 7 dead."""
    _, tidx, x = _state("euclidean", 1001, 20, seed=7, dead=7)
    q = _queries(x, 5, seed=8)
    fn, route = make_exact_fn(tidx, 10, precision=precision)
    assert route == "unfused" and fn.quant == []
    ids, d = _run_port(fn, "euclidean", q)
    if precision == "int8":
        rows_i8, iscale = fn.quant
        assert rows_i8.dtype == torch.int8 and rows_i8.shape == (1008, 24)
        assert not rows_i8[1001:].any() and not rows_i8[:, 20:].any()
        assert iscale.dtype == torch.float32 and iscale.shape == (1001,)
    else:
        (rows_bf16,) = fn.quant
        assert rows_bf16.dtype == torch.bfloat16 and rows_bf16.shape == (1001, 20)
    wids, wd = _unfused_as_before(tidx, 10, precision == "int8", q)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(d.view(np.int32), wd.view(np.int32))


def test_quantized_rows_by_chunks_equal_whole():
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal((50, 13)).astype(np.float32))
    rows[4] = 0.0
    for a, b in zip(t_search._quantized_rows(rows, True, chunk=7),
                    t_search._quantized_rows(rows, True, chunk=64)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the kernel's plan and its orders
# ---------------------------------------------------------------------------


def test_plan_picks_each_regime_at_its_boundaries():
    P = rs._plan
    for c in (32, 40, 128):  # every c the main path sends, at B = 2048
        for n2 in (784, 7824, None):
            assert P(2048, c, n2, 768, 10) == rs.Plan("warp", 8, 1, 256, 0, False)
    # the warp regime: its sorts of 256 and 512, from 7 queries an SM
    assert P(2048, 256, 15_648, 768, 10).regime == P(2048, 512, None, 768, 10).regime == "warp"
    assert P(924, 32, 784, 768, 10) == rs.Plan("warp", 8, 1, 116, 0, False)
    assert P(923, 32, 784, 768, 10) == rs.Plan("block", 1, 1, 923, 0, False, True)
    assert P(1, 32, 784, 768, 10) == rs.Plan("block", 1, 1, 1, 0, False, False)
    # the block regime: past 512 candidates; registers capped past 2 queries an SM
    assert P(2048, 513, None, 768, 10) == rs.Plan("block", 1, 1, 2048, 0, False, True)
    assert not P(264, 2048, None, 768, 100).capped and P(265, 2048, None, 768, 100).capped
    assert P(2048, rs.SMEM_CANDIDATES, None, 768, 10).stride == 0
    # past SMEM_CANDIDATES: 20 bytes a candidate, 16-byte aligned
    assert P(2048, rs.SMEM_CANDIDATES + 1, None, 768, 10).stride == 40_992
    # the split regime: queries for at most 3/4 of the SMs, CTAs for two an SM
    assert P(100, 2048, None, 768, 100).regime == "block"
    assert P(99, 2048, None, 768, 100) == rs.Plan("split", 1, 3, 297, 8 * 2148, True)
    assert P(4, 100_000, None, 768, 25_000) == rs.Plan("split", 1, 66, 264, 8 * 125_000, True)
    assert P(1, 100_000, None, 768, 10) == rs.Plan("split", 1, 264, 264, 8 * 100_010, True)
    assert P(64, 8192, None, 768, 1000).splits == 5
    # the cut's split regime slices the n2 positions
    assert P(16, 4096, 20000, 768, 1) == rs.Plan("split", 1, 17, 272, 8 * 20_001, True)
    # a CTA takes SPLIT_MIN_COLUMNS at least; none to split: block
    assert P(1, 2048, None, 768, 10).splits == 2048 // rs.SPLIT_MIN_COLUMNS
    assert P(4, 2047, None, 768, 10).regime == "block"
    # another card's SM count
    assert P(64, 8192, None, 768, 1000, sms=100).splits == 4
    assert P(76, 8192, None, 768, 1000, sms=100).regime == "block"
    assert P(700, 32, 784, 768, 10, sms=100).regime == "warp"
    # wide rows: fewer queries a CTA, then none (a CTA a query, as before)
    assert P(2048, 32, 784, 20_000, 10) == rs.Plan("warp", 2, 1, 1024, 0, False)
    assert P(2048, 32, 784, 56_000, 10).per_cta == 1
    assert P(2048, 32, 784, 57_000, 10).regime == "block"
    assert rs.Plan("block", 1, 1, 8, 0, False, True).code == 3
    assert [rs.Plan(r, 1, 1, 1, 0, False).code for r in ("warp", "block", "split")] == [0, 1, 2]


def test_plans_list_every_regime_that_can_run():
    """`_plans` (the plans the A/B script and the card's tests force) holds
    `_plan`'s pick at every shape, and each regime only where it can run."""
    Ps = rs._plans
    for b in (1, 4, 99, 100, 132, 264, 265, 923, 924, 2048):
        for c, n2 in ((32, 784), (128, 7824), (512, None), (513, None), (2048, None),
                      (4096, 20000), (100_000, None)):
            k = min(10, c)
            plans = Ps(b, c, n2, 768, k)
            assert rs._plan(b, c, n2, 768, k) in plans.values()
            assert ("warp" in plans) == (c <= rs.WARP_MAX_C)
            assert plans["block capped"] == plans["block"]._replace(capped=True)
            assert all(p.regime == n.split()[0] for n, p in plans.items())
    # the split regime of two CTAs a query, which `_plan` gives no B on 132 SMs
    assert Ps(132, 2048, None, 768, 100)["split"] == rs.Plan("split", 1, 2, 264, 8 * 2148, True)
    assert Ps(132, 2048, 20000, 768, 10)["split"].splits == 2
    assert all(rs._plan(b, 2048, None, 768, 100).splits != 2 for b in range(1, 2049))
    # no split where one CTA would hold every column; none of a warp for wide rows
    assert "split" not in Ps(264, 2048, None, 768, 10) and "split" not in Ps(1, 256, None, 768, 10)
    assert "warp" not in Ps(2048, 32, 784, 57_000, 10)


def _asc_key(d):
    u = np.asarray(d, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _lsd_order(keys):
    """The top-k order of the one-regime kernel (a CTA a query): a stable
    LSD radix sort of the keys, four 8-bit passes (a pass with one digit
    for every key skipped)."""
    order = np.arange(len(keys))
    for shift in (0, 8, 16, 24):
        dig = (keys[order] >> shift) & 255
        if (dig == dig[0]).all():
            continue
        order = order[np.argsort(dig, kind="stable")]
    return order


def _bitonic(v):
    """The kernel's warp bitonic network on 32·R composites, element e =
    r·32 + lane (`bitonic` in csrc/rescore.cu)."""
    v, n, e = v.copy(), len(v), np.arange(len(v))
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            o = v[e ^ stride]
            take_min = ((e & stride) == 0) == ((e & size) == 0)
            v = np.where(take_min, np.minimum(v, o), np.maximum(v, o))
            stride //= 2
        size *= 2
    return v


def _radix_select(vals, need):
    """`block_select`: the `need` largest of uint32 `vals` → (prefix, pmask,
    remaining, all)."""
    prefix = pmask = 0
    remaining, all_ = need, False
    for shift in (24, 16, 8, 0):
        hist = np.bincount((vals[(vals & pmask) == prefix] >> shift) & 255, minlength=256)
        acc = 0
        for dig in range(255, -1, -1):
            if acc + hist[dig] >= remaining:
                rem, all_ = remaining - acc, hist[dig] == remaining - acc
                break
            acc += hist[dig]
        prefix, pmask, remaining = prefix | dig << shift, pmask | 255 << shift, rem
        if all_:
            break
    return np.uint32(prefix), np.uint32(pmask), remaining, all_


_NONE = np.uint64(2**64 - 1)


def _small_topk(v, k):
    """`block_small_topk`: select the k-th distance key, append in any
    order (shuffled here), the lowest columns among ties by a second
    select, then the bitonic network over 128."""
    part = v != _NONE
    hi, lo = (v >> np.uint64(32)).astype(np.uint32), (v & np.uint64(2**32 - 1)).astype(np.uint32)
    prefix, pmask, rem, all_ = _radix_select(~hi[part], k)
    m = ~hi & pmask
    keep = part & ((m > prefix) | (all_ & (m == prefix)))
    if not all_:
        eq = part & (m == prefix)
        p2, m2, _, _ = _radix_select(~lo[eq], rem)
        keep |= eq & ((~lo & m2) >= p2)
    kept = np.random.default_rng(0).permutation(v[keep])
    assert len(kept) == k
    return _bitonic(np.concatenate([kept, np.full(128 - k, _NONE)]))[:k]


def _ordered_topk(v, k):
    """`block_keep` (select, then the kept in index order) and the stable
    LSD sort of what is kept."""
    part = v != _NONE
    hi = (v >> np.uint64(32)).astype(np.uint32)
    prefix, pmask, rem, _ = _radix_select(~hi[part], k)
    m = ~hi & pmask
    eq = part & (m == prefix)
    keep = part & ((m > prefix) | (eq & (np.cumsum(eq) - 1 < rem)))
    kept = v[keep]
    return kept[_lsd_order((kept >> np.uint64(32)).astype(np.uint32))]


def _composites(seed, n, dead=0.0):
    """n distance keys with many ties, +inf (not valid), NaN (as the card
    makes it and as torch does), as (asc_key << 32 | column); a share of
    the entries kNone (positions the cut did not keep)."""
    rng = np.random.default_rng(seed)
    d = rng.choice(np.float32([0.0, -0.0, 0.5, 1.5, 1.5000001, 2.0, 7.0]), n)
    d[rng.random(n) < 0.2] = np.inf
    d[rng.random(n) < 0.05] = np.uint32(0x7FFFFFFF).view(np.float32)
    d[rng.random(n) < 0.05] = np.float32("nan")
    v = (_asc_key(d).astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    v[rng.random(n) < dead] = _NONE
    return v


@pytest.mark.parametrize("c", [1, 7, 32, 40, 64, 100, 128, 129, 256, 512])
def test_warp_bitonic_order_is_the_stable_lsd_order(c):
    """The warp regime's top-k: the bitonic network over next_pow2(c) >= 32
    composites (padding kNone) gives the stable LSD order of the keys,
    ties by column, NaN and +inf included; and over keys from
    `rescore_distances`, the first k are what `rescore_topk_reference`
    returns."""
    for seed in range(20):
        v = _composites(seed, c)
        n = max(32, 1 << (c - 1).bit_length())
        got = _bitonic(np.concatenate([v, np.full(n - c, _NONE)]))[:c]
        keys = (v >> np.uint64(32)).astype(np.uint32)
        np.testing.assert_array_equal(got & np.uint64(2**32 - 1), _lsd_order(keys))
    s, rng = _inputs("euclidean", 6, 50, 8, "f32", 0.7, seed=c)
    cand = rng.integers(0, 50, size=(6, c))  # repeated slots: equal distances
    valid = s["live"].numpy()[cand]
    k = max(1, c // 3)
    d = rs.rescore_distances(t_metric("euclidean"), s["qv"], s["qn"], s["qe"],
                             torch.from_numpy(cand), s["rows"], s["norms"], s["extras"],
                             torch.from_numpy(valid)).numpy()
    _, rd = rs.rescore_topk_reference(t_metric("euclidean"), 8, k, torch.from_numpy(cand),
                                      torch.from_numpy(valid), *_stage_args(s), normalize=False)
    for b in range(6):
        v = (_asc_key(d[b]).astype(np.uint64) << np.uint64(32)) | np.arange(c, dtype=np.uint64)
        n = max(32, 1 << (c - 1).bit_length())
        got = _bitonic(np.concatenate([v, np.full(n - c, _NONE)]))[:k]
        np.testing.assert_array_equal(got & np.uint64(2**32 - 1), _lsd_order(_asc_key(d[b]))[:k])
        np.testing.assert_array_equal(d[b][(got & np.uint64(2**32 - 1)).astype(np.int64)],
                                      rd.numpy()[b])


@pytest.mark.parametrize("n,k,dead", [(300, 10, 0.0), (2048, 128, 0.0), (5000, 1, 0.7),
                                       (5000, 100, 0.7), (3000, 1000, 0.0), (4096, 1500, 0.5)])
def test_select_then_sort_is_the_stable_lsd_order(n, k, dead):
    """The block and split regimes' finish: k <= 128 by select, append in
    any order and the bitonic network; past 128 by select, compaction in
    column order and the stable LSD sort.  Both give the first k of the
    stable LSD order of the participating keys, over many equal
    distances, NaN, +inf and kNone entries (the split cut's positions it
    did not keep)."""
    for seed in range(4):
        v = _composites(seed, n, dead)
        part = np.flatnonzero(v != _NONE)
        want = part[_lsd_order((v[part] >> np.uint64(32)).astype(np.uint32))][:k]
        got = (_small_topk if k <= 128 else _ordered_topk)(v, k)
        np.testing.assert_array_equal(got & np.uint64(2**32 - 1), want)
        np.testing.assert_array_equal(_ordered_topk(v, k) & np.uint64(2**32 - 1), want)
