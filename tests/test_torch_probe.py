"""The port's leaf-probe engine against the JAX package's, on one index.

Each metric's index is built once with the JAX package and written to
disk; the port opens that same directory, so both packages probe the
identical forest.  Inputs are made with numpy from a seed.

Tolerances:
- gather-score: |port - JAX| <= 1e-5 · Σ_d |row·q| (f32 sums in another
  order);
- block tables: every array bit-equal (bf16 rows as uint16 bits);
- searches: ids equal tie-aware; distances rtol 1e-5, with an absolute
  floor of 1e-6 for the f32 cancellation in cosine's ``1 - cos``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import probe as j_probe
from arroy_tpu.ops.pallas_probe import gather_score as j_gather_score
from arroy_tpu_torch import probe as t_probe
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.ops import gather_score as t_gs
from arroy_tpu_torch.ops.gather_score import gather_score, gather_score_reference

from .torch_util import dots_epilogue, tie_aware_equal

M, DIM, TREES, K = 2000, 32, 6, 10
PROBE = dict(engine="forest", traversal="probe", probe_trees=4, probe_block=16)


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((16, DIM)).astype(np.float32)
    pa, pb = rng.integers(16, size=M), rng.integers(16, size=M)
    mask = rng.random((M, DIM)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    x += 0.05 * rng.standard_normal((M, DIM)).astype(np.float32)
    q = x[rng.integers(M, size=48)] + 0.01 * rng.standard_normal((48, DIM)).astype(np.float32)
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


def _arrays(results):
    ids = np.zeros((len(results), K), np.int64)
    d = np.full((len(results), K), np.nan)
    for i, row in enumerate(results):
        ids[i, : len(row)] = [j for j, _ in row]
        d[i, : len(row)] = [v for _, v in row]
    return ids, d


def _assert_same(jres, tres):
    jids, jd = _arrays(jres)
    tids, td = _arrays(tres)
    np.testing.assert_array_equal(np.isnan(jd), np.isnan(td))
    tie_aware_equal(tids, np.nan_to_num(td), jids, np.nan_to_num(jd), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 3: the plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_gather_score_reference_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    nbt, p, d, b, c = 10, 8, 128, 5, 7
    xf = rng.standard_normal((nbt, p, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    bid = rng.integers(nbt, size=(b, c)).astype(np.int32)
    bid[0, :2] = bid[0, 2]  # repeated ids
    bid[1, -1] = nbt - 1  # the last block
    if dtype == "int8":
        jx = np.clip(np.rint(xf * 40), -127, 127).astype(np.int8)
        tx = torch.from_numpy(jx)
    elif dtype == "bf16":
        jx = xf.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(jx.view(np.int16)).view(torch.bfloat16)
    else:
        jx = xf
        tx = torch.from_numpy(xf)
    want = np.asarray(j_gather_score(jnp.asarray(jx), jnp.asarray(bid), jnp.asarray(q), interpret=True))
    ep = dots_epilogue(tx)
    got = gather_score(tx, torch.from_numpy(bid), torch.from_numpy(q), ep).numpy()
    np.testing.assert_array_equal(got, gather_score_reference(tx, torch.from_numpy(bid), torch.from_numpy(q), ep).numpy())
    rows = np.asarray(jx, np.float32)[bid]  # [b, c, p, d]
    mag = np.einsum("bcpd,bd->bcp", np.abs(rows), np.abs(q))
    assert got.shape == (b, c, p)
    assert np.all(np.abs(got - want) <= 1e-5 * mag)


@pytest.mark.parametrize("b,c,nbt", [(1, 1, 3), (37, 11, 60), (256, 72, 400), (300, 2, 1)])
def test_block_schedule_covers_every_pair_once(b, c, nbt):
    """The kernel's schedule: every (b, c) pair exactly once, sorted by
    block id, each id the pair's own; the kernel reads a block once per
    run of it within each slice of 32 pairs."""
    rng = np.random.default_rng(b + c)
    bid = torch.from_numpy(rng.integers(nbt, size=(b, c)).astype(np.int32))
    keys, pairs = t_gs.block_schedule(bid, nbt)
    assert keys.dtype == torch.int32 and pairs.dtype == torch.int32
    assert torch.equal(torch.sort(pairs).values, torch.arange(b * c, dtype=torch.int32))
    assert torch.equal(keys, bid.reshape(-1)[pairs.long()])
    assert bool((keys[1:] >= keys[:-1]).all())
    reads = t_gs.block_reads(keys)
    distinct = int(torch.unique(bid).numel())
    assert distinct <= reads <= distinct + -(-b * c // t_gs.SLICE) - 1
    if nbt == 1:  # one hot block: read once by each CTA
        assert reads == -(-b * c // t_gs.SLICE)


def test_vec_bytes_leaves_no_lane_idle():
    """Load widths: an int8 row of 768 takes 8-byte loads (96 vectors, 3 a
    lane) over 16-byte ones (48: half the lanes idle for the last third);
    odd rows and unaligned bases take the widest width that divides both."""
    def vb(dtype, d, offset=0):
        flat = torch.zeros(2 * 4 * d + offset, dtype=dtype)
        return t_gs._vec_bytes(flat[offset:].view(2, 4, d))

    assert vb(torch.int8, 768) == 8
    assert vb(torch.bfloat16, 768) == 16 and vb(torch.float32, 768) == 16
    assert vb(torch.int8, 100) == 4 and vb(torch.int8, 37) == 1
    assert vb(torch.bfloat16, 100) == 8
    assert vb(torch.int8, 768, 3) == 1 and vb(torch.bfloat16, 768, 1) == 2
    assert vb(torch.float32, 768, 1) == 4


# ---------------------------------------------------------------------------
# block tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "metric,dtype",
    [(m, t) for m in ("euclidean", "cosine", "dot-product", "manhattan")
     for t in ("bf16", "int8", "f32", "bq")]
    + [("binary quantized cosine", "bq")],
)
def test_build_tables_np_bit_equal(index, metric, dtype):
    jr, tr, _ = index(metric)
    js, ts = jr._state, tr._state
    want = j_probe.build_tables_np(js.metric, js.dims, js.store, js.forest, 4, 16, dtype)
    got = t_probe.build_tables_np(ts.metric, ts.dims, ts.store, ts.forest, 4, 16, dtype)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            if w.dtype == ml_dtypes.bfloat16:
                w = w.view(np.uint16)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=key)
        else:
            assert g == w, key


def test_bf16_rounding_matches_ml_dtypes():
    """PyTorch's f32 → bf16 cast rounds like ml_dtypes (nearest even),
    including halfway cases, subnormals, infinities and signed zeros."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0x3F808000, 0x3F818000, 0x00000001, 0x80000000]  # ties, subnormal, -0
    x = bits.view(np.float32)
    x = np.concatenate([x[np.isfinite(x)], np.float32([np.inf, -np.inf, 0.0])])
    np.testing.assert_array_equal(t_probe._bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))


# ---------------------------------------------------------------------------
# the serving path: Searcher(engine="forest", traversal="probe")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "metric,dtype,search_k",
    [
        ("euclidean", "bf16", 600),
        ("cosine", "bf16", 600),
        ("dot-product", "bf16", 600),
        ("manhattan", "bf16", 600),
        ("euclidean", "int8", 600),
        ("euclidean", "f32", 600),
        ("euclidean", "bq", 1200),
        ("cosine", "bq", 1200),
        ("binary quantized euclidean", "auto", 600),
    ],
)
def test_probe_matches_jax(index, metric, dtype, search_k):
    jr, tr, q = index(metric)
    kw = dict(PROBE, search_k=search_k, probe_dtype=dtype)
    s = tr.searcher(K, **kw)
    assert s.engine == "forest" and s.route == "probe"
    _assert_same(jr.searcher(K, **kw)(q), s(q))
    # one upload per geometry: a second searcher reuses the cached tables
    assert tr.searcher(K, **kw).device_fn.tables is s.device_fn.tables


def test_probe_chunked_matches_jax(index, monkeypatch):
    """PROBE_GATHER_BYTES=1 forces one block per chunk and a chunked
    re-score; the merged winners equal the JAX package's unchunked run."""
    jr, tr, q = index("euclidean")
    kw = dict(PROBE, search_k=600)
    want = jr.searcher(K, **kw)(q)
    monkeypatch.setattr(t_probe, "PROBE_GATHER_BYTES", 1)
    _assert_same(want, tr.searcher(K, **kw)(q))


@pytest.mark.parametrize(
    "metric,n_cand,rescore,route",
    [
        ("euclidean", 900, "auto", "probe"),
        ("euclidean", 40, "exact", "filter_pool"),
        ("cosine", 40, "auto", "filter_pool"),
        ("dot-product", 40, "auto", "filter_pool"),
    ],
)
def test_probe_filtered_matches_jax(index, metric, n_cand, rescore, route):
    """A filter larger than the budget masks block slots in the probe;
    one that fits the budget is re-scored whole (the tiny-pool shortcut:
    per candidate, or, at B·pool >= M, by the matmul re-score, held here
    on the metrics whose matmul distances carry no ‖x‖² cancellation)."""
    jr, tr, q = index(metric)
    cand = np.random.default_rng(11).choice(M, n_cand, replace=False)
    kw = dict(PROBE, search_k=600, candidates=cand, rescore=rescore)
    s = tr.searcher(K, **kw)
    assert s.route == route
    got = s(q)
    _assert_same(jr.searcher(K, **kw)(q), got)
    assert set(i for row in got for i, _ in row) <= set(cand.tolist())


def test_traversal_auto_policy(index, monkeypatch):
    """traversal="auto" serves the probe at or above _PROBE_MIN_ITEMS;
    below it, and with traversal="xla", the best-first traversal, whose
    results equal the JAX package's traversal on the same forest."""
    jr, tr, q = index("euclidean")
    monkeypatch.delenv("ARROY_TRAVERSAL", raising=False)
    monkeypatch.setattr(t_search, "_PROBE_MIN_ITEMS", M)
    s = tr.searcher(K, search_k=600, engine="forest", probe_trees=4, probe_block=16)
    assert s.route == "probe"
    _assert_same(tr.searcher(K, **dict(PROBE, search_k=600))(q), s(q))
    monkeypatch.setattr(t_search, "_PROBE_MIN_ITEMS", M + 1)
    want = jr.searcher(K, search_k=600, engine="forest", traversal="xla", rescore="exact")(q)
    for traversal in ("auto", "xla"):
        s = tr.searcher(K, search_k=600, engine="forest", traversal=traversal, rescore="exact")
        assert s.route == "traversal"
        _assert_same(want, s(q))


# ---------------------------------------------------------------------------
# the re-score cut: one rule for every metric, tracking search_k
# ---------------------------------------------------------------------------

SK_DOUBLING = (2000, 4000, 8000, 16000)


@pytest.fixture(scope="module")
def wide_index(tmp_path_factory):
    """8,000 x 128 of bench.py's clustered model (64 parents), 8 trees,
    built by the JAX package and opened by the port, with 64 queries of
    the same model and their exact top-10."""
    rng = np.random.default_rng(42)
    m, d = 8000, 128
    parents = rng.standard_normal((64, d)).astype(np.float32)
    pa, pb = rng.integers(64, size=m + 64), rng.integers(64, size=m + 64)
    x = np.where(rng.random((m + 64, d)) < 0.5, parents[pa], parents[pb]).astype(np.float32)
    x += 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    x, q = x[:m], x[m:]
    path = str(tmp_path_factory.mktemp("wide"))
    db = arroy_tpu.Database(path)
    w = arroy_tpu.Writer(db, 0, d)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(8).build(wtxn)
    jr = arroy_tpu.Reader.open(db.read(), 0, db)
    tdb = arroy_tpu_torch.Database(path, device="cpu")
    tr = arroy_tpu_torch.Reader.open(tdb.read(), 0, tdb)
    exact = _arrays(tr.searcher(K, engine="exact", precision="f32x1")(q))[0]
    return jr, tr, q, exact


def _probe_recall(tr, q, exact, sk):
    s = tr.searcher(K, search_k=sk, engine="forest", traversal="probe", probe_trees=8,
                    probe_block=16)
    ids = _arrays(s(q))[0]
    return sum(len(set(a) & set(b)) for a, b in zip(ids, exact)) / exact.size, s.device_fn.k2


def test_probe_recall_does_not_fall_as_search_k_doubles(wide_index, monkeypatch):
    """With the JAX package's cut (512 for a built-in metric) recall falls
    as search_k doubles past 4000 on this corpus; with the port's (an
    eighth of search_k past the floor) it never falls."""
    _, tr, q, exact = wide_index
    monkeypatch.setattr(t_probe, "JAX_CUT", True)
    jax_cut = [_probe_recall(tr, q, exact, sk) for sk in SK_DOUBLING]
    assert {k2 for _, k2 in jax_cut} == {512}
    assert jax_cut[-1][0] < max(r for r, _ in jax_cut)  # the fault, shown on this data
    monkeypatch.setattr(t_probe, "JAX_CUT", False)
    own = [_probe_recall(tr, q, exact, sk) for sk in SK_DOUBLING]
    assert [k2 for _, k2 in own] == [512, 512, 1024, 2048]
    rec = [r for r, _ in own]
    assert all(b >= a for a, b in zip(rec, rec[1:])), rec
    assert all(a >= b for (a, _), (b, _) in zip(own, jax_cut))


@pytest.mark.parametrize("sk", [4000, 8000, 16000])
def test_probe_matches_jax_at_jax_cut(wide_index, monkeypatch, sk):
    """At the JAX package's cut the port's probe returns its results, at a
    budget where the port's own cut is the same and at two where it is
    wider."""
    jr, tr, q, _ = wide_index
    kw = dict(search_k=sk, engine="forest", traversal="probe", probe_trees=8, probe_block=16)
    assert tr.searcher(K, **kw).device_fn.k2 == {4000: 512, 8000: 1024, 16000: 2048}[sk]
    monkeypatch.setattr(t_probe, "JAX_CUT", True)
    s = tr.searcher(K, **kw)
    assert s.device_fn.k2 == 512
    _assert_same(jr.searcher(K, **kw)(q), s(q))


def test_rescore_cut_rule():
    """One rule: the floor max(32·k, 512); past it an eighth of search_k
    for an exact in-block score, half of it for an estimate's, whose floor
    is 3x; capped by the pool."""
    cut = t_probe.rescore_cut
    assert cut(10, 600, 10**6, False, False) == 512
    assert cut(10, 4000, 10**6, False, False) == 512
    assert cut(10, 32000, 10**6, False, False) == 4096
    assert cut(10, 32000, 3000, False, False) == 3000
    assert cut(10, 32000, 10**6, True, False) == cut(10, 32000, 10**6, False, True) == 16384
    assert cut(10, 600, 10**6, True, False) == cut(10, 600, 10**6, False, True) == 2048
    assert cut(40, 600, 10**6, False, False) == 2048
