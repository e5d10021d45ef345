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
