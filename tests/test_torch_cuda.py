"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every case is marked `gpu` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest -p no:cacheprovider

Tolerances: int8 select keys/indices and hamming counts bit-equal; bf16
select keys within 2·bm with >= 98% equal and indices equal where keys
are (that of `tests/test_pallas_exact.py`); gather-score within
1e-5 · Σ_d |row·q| of the plain version (the same operands, summed in
another order).  The forest traversal (no kernel of its own) against the
same index searched on the CPU, on the same margins: leaf logs, pops,
counts and filtered candidates bit-equal; results tie-aware, distances
rtol 1e-5 with a 1e-6 floor (re-scores summed in another order).  The
streaming exact scans against the same index scanned on the CPU: f32
tie-aware at rtol 1e-5, BQ distances bit-equal with ids tie-aware.
"""

import warnings

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch.ops import bq_kernels, fused_select
from arroy_tpu_torch.ops import gather_score as gs
from arroy_tpu_torch.ops.fused_select import DEAD_KEY_MAX, fused_block_select

from . import torch_golden
from .torch_util import recall, require_cuda, tie_aware_equal, to_torch

pytestmark = pytest.mark.gpu


def _select_inputs(dev, b, m, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((b, d)).astype(np.float32)
    xf = rng.standard_normal((m, d)).astype(np.float32)
    if dtype == "int8":
        q = torch.from_numpy(np.clip(np.round(qf * 20), -127, 127).astype(np.int8))
        x = torch.from_numpy(np.clip(np.round(xf * 20), -127, 127).astype(np.int8))
    else:
        q, x = torch.from_numpy(qf).to(torch.bfloat16), torch.from_numpy(xf).to(torch.bfloat16)
    qsc = rng.random(b).astype(np.float32) + 0.5
    mult = rng.random(m).astype(np.float32) + 0.5
    add = rng.standard_normal(m).astype(np.float32)
    add[rng.random(m) < 0.1] = -np.inf
    return tuple(torch.as_tensor(a).to(dev) for a in (q, x, qsc, mult, add))


def _check_select(dtype, b, m, d, bm):
    dev = require_cuda()
    inputs = _select_inputs(dev, b, m, d, dtype)
    n0 = fused_select.launches[f"fused_select_{dtype}"]
    keys, idx = fused_block_select(*inputs, bm=bm)
    rkeys, ridx = fused_select.fused_block_select_reference(*inputs, bm=bm)
    assert fused_select.launches[f"fused_select_{dtype}"] == n0 + 1
    dead = ~torch.isfinite(inputs[4])[idx.long()]
    assert not bool((dead & (keys > DEAD_KEY_MAX)).any())
    if dtype == "int8":
        assert torch.equal(keys, rkeys) and torch.equal(idx, ridx)
    else:
        dk = (keys.long() - rkeys.long()).abs()
        eq = dk == 0
        assert int(dk.max()) <= 2 * bm and float(eq.float().mean()) >= 0.98
        assert torch.equal(idx[eq], ridx[eq])


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("b,m,bm", [(130, 8192, 256), (5, 4096, 1024), (64, 2048, 256)])
def test_cuda_select_matches_plain(dtype, b, m, bm):
    _check_select(dtype, b, m, 256, bm)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("b", [1, 65, 130, 2048])
@pytest.mark.parametrize("m", [4096, 100_352])
@pytest.mark.parametrize("d", [128, 768])
def test_cuda_select_ragged_shapes(dtype, b, m, d):
    """A partial query tile (B = 65, 130), one under a single warpgroup
    (B = 1), the smallest corpus the fused gate admits (Mp = 4096), one
    int8 K-slice (d = 128), at bm = 1024."""
    _check_select(dtype, b, m, d, 1024)


def _hamming_words(dev, n, w, rng, offset=0):
    """[n, w] random packed words on `dev`; with an offset, a contiguous
    view `offset` words into its storage (not 16-byte aligned)."""
    a = to_torch(rng.integers(0, 2**32, n * w + offset, dtype=np.uint64).astype(np.uint32), dev)
    return a[offset:].view(n, w)


# every B of {1, 65, 130, 2048} with every M of {1, 127, 1537, 100,000} at
# w = 24 (d = 768); w around one 8-word k-step, d = 1280 and w = 320 (past
# the SIMT kernel's old cap of 306); earlier odd shapes
HAMMING_SHAPES = [(b, m, 24) for b in (1, 65, 130, 2048) for m in (1, 127, 1537, 100_000)] + [
    (130, 1537, w) for w in (1, 7, 8, 9, 40, 320)] + [(1, 1, 2), (9, 700, 33)]


@pytest.mark.parametrize("b,m,w", HAMMING_SHAPES)
def test_cuda_hamming_matches_plain(b, m, w):
    dev = require_cuda()
    rng = np.random.default_rng(b + m + w)
    q, x = _hamming_words(dev, b, w, rng), _hamming_words(dev, m, w, rng)
    n0 = bq_kernels.launches["bq_hamming"]
    got = bq_kernels.bq_hamming_matrix(q, x)
    assert bq_kernels.launches["bq_hamming"] == n0 + 1
    assert torch.equal(got, bq_kernels.bq_hamming_matrix_reference(q, x))


def test_cuda_hamming_unaligned_rows():
    """Rows that do not start on 16 bytes take the kernel's 4-byte copies."""
    dev = require_cuda()
    rng = np.random.default_rng(5)
    q, x = _hamming_words(dev, 130, 24, rng, 1), _hamming_words(dev, 1537, 24, rng, 3)
    assert q.data_ptr() % 16 and x.data_ptr() % 16
    assert torch.equal(bq_kernels.bq_hamming_matrix(q, x), bq_kernels.bq_hamming_matrix_reference(q, x))


def test_cuda_wrappers_reject_bad_inputs():
    dev = require_cuda()
    q, x, qsc, mult, add = _select_inputs(dev, 4, 512, 256, "int8")
    with pytest.raises(ValueError):
        fused_block_select(q[:, :200].contiguous(), x[:, :200].contiguous(), qsc, mult, add)
    with pytest.raises(TypeError):
        fused_block_select(q, x.to(torch.bfloat16), qsc, mult, add)
    with pytest.raises(ValueError):
        bq_kernels.bq_hamming_matrix(torch.zeros((2, 4), dtype=torch.int32, device=dev),
                                     torch.zeros((3, 5), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # mismatched w past the old cap
        bq_kernels.bq_hamming_matrix(torch.zeros((2, 320), dtype=torch.int32, device=dev),
                                     torch.zeros((3, 321), dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        bq_kernels.bq_hamming_matrix(torch.zeros((2, 4), dtype=torch.int64, device=dev),
                                     torch.zeros((3, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        bq_kernels.bq_hamming_matrix(torch.zeros((4, 2), dtype=torch.int32, device=dev).t(),
                                     torch.zeros((3, 4), dtype=torch.int32, device=dev))
    # w = 320 (d = 10,240) is taken: the kernel has no width cap
    ones = torch.full((2, 320), -1, dtype=torch.int32, device=dev)
    assert torch.equal(bq_kernels.bq_hamming_matrix(ones, torch.zeros((3, 320), dtype=torch.int32, device=dev)),
                       torch.full((2, 3), 320 * 32, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("metric,precision,route", [
    ("euclidean", "int8", "fused_select"),
    ("cosine", "bf16", "fused_select"),
    ("binary quantized euclidean", "auto", "bq_matrix"),
])
def test_cuda_searcher_runs_the_kernels(tmp_path, metric, precision, route):
    dev = require_cuda()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    db = Database(str(tmp_path), device=dev)
    w = Writer(db, 0, 64, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=1).n_trees(2).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric=metric)
    r.assert_validity()
    n0 = sum(fused_select.launches.values()) + bq_kernels.launches["bq_hamming"]
    s = r.searcher(10, precision=precision)
    assert s.route == route
    got = s(x[:32] + 0.01)
    assert sum(fused_select.launches.values()) + bq_kernels.launches["bq_hamming"] > n0
    # the same persisted index searched on the CPU runs the plain versions
    cpu = Database(str(tmp_path), device="cpu")
    ref = Reader.open(cpu.read(), 0, cpu, metric=metric).searcher(10, precision=precision)(x[:32] + 0.01)
    ids, d = (np.array([[p[j] for p in row] for row in got]) for j in (0, 1))
    rids, rd = (np.array([[p[j] for p in row] for row in ref]) for j in (0, 1))
    if r.metric.binary:  # exact integer distances, full of ties
        tie_aware_equal(ids, d, rids, rd, rtol=0, atol=1e-6)
    else:
        assert recall(ids, rids) >= 0.99


def _gather_inputs(dev, nbt, p, d, b, c, dtype, seed=0, round_q=False):
    """Rows [nbt, p, d] of `dtype`, ids [b, c] with repeats and the last
    block, f32 queries [b, d] (rounded to bf16 values, as the probe sends
    them for bf16 and int8 tables, when `round_q`)."""
    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.standard_normal((nbt, p, d)).astype(np.float32))
    rows = {"f32": xf, "bf16": xf.to(torch.bfloat16),
            "int8": torch.clamp(torch.round(xf * 40), -127, 127).to(torch.int8)}[dtype]
    bid = rng.integers(nbt, size=(b, c)).astype(np.int32)
    if b and c:
        bid[0, :] = bid[0, 0]  # one query repeats one block
        bid[-1, -1] = nbt - 1  # the last block
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    if round_q:
        q = q.to(torch.bfloat16).float()
    return rows.to(dev), torch.from_numpy(bid).to(dev), q.to(dev)


def _gather_bound(rows, bid, q):
    """1e-5 · Σ_d |row·q| for every output element."""
    return 1e-5 * torch.einsum("bcpd,bd->bcp", rows[bid.long()].float().abs(), q.abs())


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize(
    "nbt,p,d,b,c",
    [(50, 64, 768, 7, 1), (50, 48, 768, 5, 9), (30, 64, 100, 6, 5), (9, 16, 100, 3, 13), (40, 48, 37, 4, 3), (8, 64, 768, 0, 4)],
)
def test_cuda_gather_score_matches_plain(dtype, nbt, p, d, b, c):
    dev = require_cuda()
    rows, bid, q = _gather_inputs(dev, nbt, p, d, b, c, dtype)
    name = f"gather_score_{dtype}"
    n0 = gs.launches[name]
    got = gs.gather_score(rows, bid, q)
    want = gs.gather_score_reference(rows, bid, q)
    torch.cuda.synchronize()
    assert got.shape == (b, c, p) and got.dtype == torch.float32
    assert gs.launches[name] == n0 + (1 if b and c else 0)
    assert bool(((got - want).abs() <= _gather_bound(rows, bid, q)).all())


@pytest.fixture(params=["schedule", "query order"])
def gather_order(request, monkeypatch):
    """Every gather case both ways: the pairs sorted by block first (as calls
    of SCHEDULE_MIN_BYTES or more run), and scored in query order."""
    monkeypatch.setattr(gs, "SCHEDULE_MIN_BYTES", 0 if request.param == "schedule" else 2**62)
    return request.param


def _check_gather(rows, bid, q):
    """One launch, and every output within the tolerance of the plain version."""
    name = gs._ROW_TYPES[rows.dtype][1]
    n0 = gs.launches[name]
    got = gs.gather_score(rows, bid, q)
    want = gs.gather_score_reference(rows, bid, q)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert gs.launches[name] == n0 + (1 if got.numel() else 0)
    assert bool(((got - want).abs() <= _gather_bound(rows, bid, q)).all())


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("round_q", [False, True])
@pytest.mark.parametrize("p", [16, 48, 64])
@pytest.mark.parametrize("d", [768, 100, 37])
def test_cuda_gather_score_shapes(dtype, round_q, p, d, gather_order):
    """P in {16, 48, 64}; d = 768 (8-byte int8 loads, 3 a lane), 100 and
    37 (narrow loads); bf16-rounded and unrounded f32 queries."""
    dev = require_cuda()
    _check_gather(*_gather_inputs(dev, 60, p, d, 37, 11, dtype, seed=p + d, round_q=round_q))


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,c", [(1, 1), (40, 3), (300, 2), (5, 70)])
def test_cuda_gather_score_one_shared_block(dtype, b, c, gather_order):
    """Every query picks the same block: one run spans many slices of 32
    pairs (300 x 2 = 600 pairs: a hot block past one CTA's cap)."""
    dev = require_cuda()
    rows, _, q = _gather_inputs(dev, 20, 64, 768, b, c, dtype, seed=b + c)
    _check_gather(rows, torch.full((b, c), 13, dtype=torch.int32, device=dev), q)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
def test_cuda_gather_score_hot_block(dtype, gather_order):
    """One block chosen by 100 queries (past one CTA's 32 pairs) among
    random others, a run that crosses slice edges."""
    dev = require_cuda()
    rows, bid, q = _gather_inputs(dev, 500, 64, 768, 128, 9, dtype, seed=21)
    bid[:100, 4] = 7
    bid[:100, 5] = 499
    _check_gather(rows, bid, q)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_gather_score_unaligned(dtype, offset, gather_order):
    """Rows and query not 16-byte aligned (contiguous views into larger
    storage): narrower loads, and the query copied to an aligned buffer."""
    dev = require_cuda()
    rows, bid, q = _gather_inputs(dev, 30, 48, 768, 9, 13, dtype, seed=offset)
    flat = torch.zeros(rows.numel() + offset, dtype=rows.dtype, device=dev)
    flat[offset:] = rows.reshape(-1)
    rows = flat[offset:].view(rows.shape)
    qf = torch.zeros(q.numel() + offset, dtype=q.dtype, device=dev)
    qf[offset:] = q.reshape(-1)
    q = qf[offset:].view(q.shape)
    assert q.data_ptr() % 16
    _check_gather(rows, bid, q)


@pytest.mark.parametrize("n,nbt", [(1, 1), (31, 5), (18_432, 34_888), (5_000, 120_000), (70_000, 300)])
def test_cuda_gather_schedule_sorts_every_pair_once(n, nbt):
    """The schedule kernel: ids sorted, every pair once, each id its pair's
    own; past 53,248 blocks it counts in several passes."""
    dev = require_cuda()
    bid = torch.from_numpy(np.random.default_rng(n).integers(nbt, size=n).astype(np.int32)).to(dev)
    keys, pairs = gs.block_schedule(bid.view(1, n), nbt)
    assert torch.equal(keys, torch.sort(bid).values)
    assert torch.equal(torch.sort(pairs).values, torch.arange(n, dtype=torch.int32, device=dev))
    assert torch.equal(bid[pairs.long()], keys)


def test_cuda_gather_score_many_blocks(gather_order):
    """60,000 blocks: the schedule's counting sort takes two passes."""
    dev = require_cuda()
    _check_gather(*_gather_inputs(dev, 60_000, 16, 37, 64, 50, "int8", seed=9))


def test_cuda_gather_score_rejects_bad_inputs():
    dev = require_cuda()
    rows, bid, q = _gather_inputs(dev, 8, 16, 64, 2, 3, "bf16")
    with pytest.raises(TypeError):
        gs.gather_score(rows.to(torch.float16), bid, q)
    with pytest.raises(TypeError):
        gs.gather_score(rows, bid.long(), q)
    with pytest.raises(ValueError):
        gs.gather_score(rows, bid, q[:, :32].contiguous())
    with pytest.raises(ValueError):
        gs.gather_score(rows, bid.t(), q)


def test_cuda_probe_searcher_runs_gather_score(tmp_path):
    """The probe engine on the card launches kernel 3 and agrees with the
    same persisted index searched on the CPU (plain versions)."""
    dev = require_cuda()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    db = Database(str(tmp_path), device=dev)
    w = Writer(db, 0, 64, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=1).n_trees(4).build(wtxn)
    kw = dict(search_k=4000, engine="forest", traversal="probe", probe_trees=4)
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    n0 = gs.launches["gather_score_bf16"]
    s = r.searcher(10, **kw)
    assert s.route == "probe"
    got = s(x[:32] + 0.01)
    assert gs.launches["gather_score_bf16"] > n0
    cpu = Database(str(tmp_path), device="cpu")
    ref = Reader.open(cpu.read(), 0, cpu, metric="euclidean").searcher(10, **kw)(x[:32] + 0.01)
    ids, d = (np.array([[p[j] for p in row] for row in got]) for j in (0, 1))
    rids, rd = (np.array([[p[j] for p in row] for row in ref]) for j in (0, 1))
    assert recall(ids, rids) >= 0.99


def _traversal_pair(tmp_path, metric="euclidean", m=6000, d=48):
    """One index searched from the card and from the CPU (the same files),
    with noisy queries (no distance in the matmul noise near zero)."""
    dev = require_cuda()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((m, d)).astype(np.float32)
    q = x[:64] + 0.5 * rng.standard_normal((64, d)).astype(np.float32)
    db = Database(str(tmp_path), device=dev)
    w = Writer(db, 0, d, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m), x)
        w.builder(seed=2).n_trees(5).build(wtxn)
    cpu = Database(str(tmp_path), device="cpu")
    return (Reader.open(db.read(), 0, db, metric=metric),
            Reader.open(cpu.read(), 0, cpu, metric=metric), q)


def _result_arrays(res):
    ids, d = res
    return ids[:, :10].cpu().numpy(), d[:, :10].cpu().numpy()


@pytest.mark.parametrize("search_k", [300, 2000])
def test_cuda_traversal_loop_matches_cpu(tmp_path, search_k):
    """Given the same margins, the pop loop on the card logs the same
    leaves, pops and counts as on the CPU, bit for bit, and expands them
    to the same candidates."""
    gr, cr, q = _traversal_pair(tmp_path)
    kw = dict(search_k=search_k, engine="forest", traversal="xla")
    gs_, cs_ = gr.searcher(10, **kw), cr.searcher(10, **kw)
    assert gs_.route == cs_.route == "traversal"
    gfn, cfn = gs_.device_fn, cs_.device_fn
    cq = cs_.prepare_queries(q)
    m = cfn.margins(cq[0], cq[3])
    for pmax, q_cap in ((gfn.pmax, gfn.q_cap), (gfn.pmax_small, gfn.q_cap_small)):
        got = gfn.traverse(m.cuda(), pmax, q_cap)
        want = cfn.traverse(m, pmax, q_cap)
        for g, c in zip(got, want):
            assert torch.equal(g.cpu(), c)
        assert torch.equal(gfn.expand(got[0]).cpu(), cfn.expand(want[0]))
    gq = gs_.prepare_queries(q)
    tie_aware_equal(*_result_arrays(gfn.run(m.cuda(), *gq[:3])), *_result_arrays(cfn.run(m, *cq[:3])),
                    rtol=1e-5, atol=1e-6)


def test_cuda_traversal_filtered_matches_cpu(tmp_path):
    """The filtered loop (a filter of 20% of the items) on the card against
    the CPU on the same margins: candidates bit-equal, results tie-aware."""
    gr, cr, q = _traversal_pair(tmp_path)
    cand = np.random.default_rng(1).choice(6000, 1200, replace=False)
    kw = dict(search_k=400, engine="forest", traversal="xla", candidates=cand)
    gfn, cfn = gr.searcher(10, **kw).device_fn, cr.searcher(10, **kw).device_fn
    assert gfn.filter_words is not None
    cq = cr.searcher(10, **kw).prepare_queries(q)
    m = cfn.margins(cq[0], cq[3])
    got, want = gfn.traverse(m.cuda(), gfn.pmax, gfn.q_cap), cfn.traverse(m, cfn.pmax, cfn.q_cap)
    for g, c in zip(got, want):
        assert torch.equal(g.cpu(), c)
    gq = tuple(t.cuda() for t in cq)
    ids, d = _result_arrays(gfn.run(m.cuda(), *gq[:3]))
    tie_aware_equal(ids, d, *_result_arrays(cfn.run(m, *cq[:3])), rtol=1e-5, atol=1e-6)
    assert set(ids.ravel().tolist()) <= set(cand.tolist())


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
def test_cuda_traversal_matmul_scan_matches_cpu(tmp_path, monkeypatch, metric):
    """The streamed matmul re-score (forced: 1-byte matrix budget, chunks
    of 1,024 items) on the card against the CPU, on the same margins."""
    from arroy_tpu_torch import search as t_search

    gr, cr, q = _traversal_pair(tmp_path, metric)
    monkeypatch.setattr(t_search, "_RESCORE_MATRIX_BYTES", 1)
    monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 1024)
    monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 1 << 20)
    kw = dict(search_k=600, engine="forest", traversal="xla", rescore="auto")
    gs_, cs_ = gr.searcher(10, **kw), cr.searcher(10, **kw)
    assert gs_.device_fn.rescore_mode(len(q)) == "matmul_scan"
    cq = cs_.prepare_queries(q)
    m = cs_.device_fn.margins(cq[0], cq[3])
    got = gs_.device_fn.run(m.cuda(), *(t.cuda() for t in cq[:3]))
    tie_aware_equal(*_result_arrays(got), *_result_arrays(cs_.device_fn.run(m, *cq[:3])),
                    rtol=1e-5, atol=1e-6)


def _sync_warnings(fn):
    """Run ``fn()`` in PyTorch's sync debug mode; returns its result and
    the (file, line) of every synchronizing call it made."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [(w.filename, w.lineno) for w in rec
                 if str(w.message).startswith("called a synchronizing CUDA operation")]


@pytest.mark.parametrize("filtered", [False, True])
def test_cuda_traversal_syncs_once_a_block(tmp_path, filtered):
    """The plain pop loop, called directly on CUDA tensors, reads the
    batch's "any query active" flag once every POP_BLOCK pops and
    synchronizes nowhere else (PyTorch's sync debug mode warns on every
    synchronizing call).  The searcher's own walk is kernel 4's
    (`test_cuda_walk_never_syncs`)."""
    from arroy_tpu_torch.search import POP_BLOCK, _traverse_batch

    gr, _, q = _traversal_pair(tmp_path)
    cand = np.arange(0, 6000, 2) if filtered else None  # 3,000 ids: more than search_k
    s = gr.searcher(10, search_k=2000, engine="forest", traversal="xla", candidates=cand)
    assert s.route == "traversal"
    fn = s.device_fn
    dq = s.prepare_queries(q)
    m = fn.margins(dq[0], dq[3])
    idx = fn.idx
    (_, pops, _), syncs = _sync_warnings(lambda: _traverse_batch(
        m, idx.node_table, idx.leaf_items, fn.roots, fn.sk, fn.sk_exact, fn.pmax, idx.max_leaf,
        q_cap=fn.q_cap, l_cap=fn.l_cap, filter_words=fn.filter_words))
    assert len(syncs) == -(-int(pops.max()) // POP_BLOCK), syncs
    assert len(set(syncs)) == 1, syncs  # all of them the block's one read


@pytest.mark.parametrize("case", ["filtered", "two_tier", "fallback"])
def test_cuda_walk_never_syncs(tmp_path, monkeypatch, case):
    """`TraversalFn.walk` launches kernel 4 once a batch and makes no
    synchronizing call: filtered (one tier), two-tier, and two-tier with a
    small tier that cuts every query (the fallback).  Its output, pops and
    outcome counters, read after, equal the CPU's walk on the same
    margins."""
    from arroy_tpu_torch import search as t_search
    from arroy_tpu_torch.ops import traverse as tv

    gr, cr, q = _traversal_pair(tmp_path)
    cand = np.arange(0, 6000, 2) if case == "filtered" else None
    mult, pad = (8, 64) if case == "two_tier" else (0, 1)
    monkeypatch.setattr(t_search, "_SMALL_POPS_MULT", mult)
    monkeypatch.setattr(t_search, "_SMALL_POPS_PAD", pad)
    kw = dict(search_k=300, engine="forest", traversal="xla", candidates=cand)
    s = gr.searcher(10, **kw)
    fn, cfn = s.device_fn, cr.searcher(10, **kw).device_fn
    assert fn.two_tier == (case != "filtered")
    dq = s.prepare_queries(q)
    m = fn.margins(dq[0], dq[3])
    n0 = tv.launches["traverse"]
    out, syncs = _sync_warnings(lambda: fn.walk(m))
    assert syncs == [] and tv.launches["traverse"] == n0 + 1
    want = cfn.walk(m.cpu())
    assert torch.equal(out.cpu(), want) and torch.equal(fn.last_pops.cpu(), cfn.last_pops)
    assert (fn.last_small_ok, fn.fallbacks) == (cfn.last_small_ok, cfn.fallbacks)
    assert fn.last_steps == int(fn.last_pops.max())
    if case == "fallback":
        assert (fn.last_small_ok, fn.fallbacks) == (False, 1)


def _kernel_index(metric="euclidean", m=30_000, d=16, n_trees=5, seed=9):
    """A DeviceIndex on the card (clustered rows, so the forests are deep),
    and 256 noisy queries prepared by a searcher of it."""
    dev = require_cuda()
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((32, d)).astype(np.float32)
    x = parents[rng.integers(32, size=m)] + 0.2 * rng.standard_normal((m, d)).astype(np.float32)
    q = x[:256] + 0.3 * rng.standard_normal((256, d)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, d, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m), x)
        w.builder(seed=seed).n_trees(n_trees).build(wtxn)
    return Reader.open(db.read(), 0, db, metric=metric), q


_KERNEL_INDEX = {}


def _kernel_fn(metric, search_k, b, filtered):
    """(TraversalFn, margins [b, S]) of the cached index of `metric`."""
    if metric not in _KERNEL_INDEX:
        _KERNEL_INDEX[metric] = _kernel_index(metric, m=30_000 if metric == "euclidean" else 6000)
    r, q = _KERNEL_INDEX[metric]
    n = r.n_items()
    cand = np.arange(0, n, 3) if filtered else None  # a third of the ids
    s = r.searcher(10, search_k=search_k, engine="forest", traversal="xla", candidates=cand)
    assert s.route == "traversal"
    dq = s.prepare_queries(q[:b])
    return s.device_fn, s.device_fn.margins(dq[0], dq[3])


def _kernel_vs_plain(fn, m, pmax, q_cap):
    """Kernel 4 and the plain loop on the same CUDA margins: bit-equal."""
    from arroy_tpu_torch.ops import traverse as tv

    idx = fn.idx
    args = (m, idx.node_table, idx.leaf_items, fn.roots, fn.sk, fn.sk_exact, pmax, idx.max_leaf)
    n0 = tv.launches["traverse"]
    got = tv.traverse(*args, q_cap=q_cap, l_cap=fn.l_cap, filter_words=fn.filter_words)
    assert tv.launches["traverse"] == n0 + 1
    want = tv.traverse_reference(*args, q_cap=q_cap, l_cap=fn.l_cap, filter_words=fn.filter_words)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    return got


@pytest.mark.parametrize("tier", ["small", "full"])
@pytest.mark.parametrize("search_k", [64, 2000, 8000])
@pytest.mark.parametrize("b", [1, 65, 256])
@pytest.mark.parametrize("filtered", [False, True])
def test_cuda_traverse_kernel_matches_plain(filtered, b, search_k, tier):
    """Leaf logs (or filtered candidate buffers), pops and counts, bit for
    bit, at both tiers' budgets and queue widths."""
    fn, m = _kernel_fn("euclidean", search_k, b, filtered)
    pmax, q_cap = (fn.pmax_small, fn.q_cap_small) if tier == "small" else (fn.pmax, fn.q_cap)
    out, pops, n_cand = _kernel_vs_plain(fn, m, pmax, q_cap)
    assert int(n_cand.max()) > 0 and int(pops.min()) > 0


@pytest.mark.parametrize("smem_lanes", [0, 16, 1000, None])
def test_cuda_traverse_kernel_spills_past_shared_memory(monkeypatch, smem_lanes):
    """Heap slots past `SMEM_LANES` live in global scratch: with it at 0
    and 16 the heap spills at once, at 1000 partway; at its own value
    (None), a q_cap past it allocates the scratch and uses its offsets."""
    from arroy_tpu_torch.ops import traverse as tv

    if smem_lanes is not None:
        monkeypatch.setattr(tv, "SMEM_LANES", smem_lanes)
    for search_k, filtered in ((8000, False), (2000, True)):
        fn, m = _kernel_fn("euclidean", search_k, 65, filtered)
        q_cap = fn.q_cap if smem_lanes is not None else tv.SMEM_LANES + 4096
        assert q_cap > tv.SMEM_LANES or smem_lanes == 1000
        _kernel_vs_plain(fn, m, fn.pmax, q_cap)


def test_cuda_traverse_kernel_free_roots():
    """The sharded forest's padding: a trailing FREE row and roots that
    point at it (popped first, as no-ops, each adding a pop)."""
    from arroy_tpu_torch.models.forest import KIND_FREE
    from arroy_tpu_torch.ops import traverse as tv

    fn, m = _kernel_fn("euclidean", 2000, 65, False)
    idx = fn.idx
    pad = torch.zeros((1, idx.node_table.shape[1]), dtype=torch.int32, device=m.device)
    pad[0, 0] = KIND_FREE
    nt = torch.cat([idx.node_table, pad])
    n = idx.node_table.shape[0]
    roots = torch.cat([fn.roots, torch.full((3,), n, dtype=torch.int64, device=m.device)])
    q_cap = fn.q_cap + 3
    args = (m, nt, idx.leaf_items, roots, fn.sk, fn.sk_exact, fn.pmax + 3, idx.max_leaf)
    got = tv.traverse(*args, q_cap=q_cap, l_cap=fn.l_cap)
    want = tv.traverse_reference(*args, q_cap=q_cap, l_cap=fn.l_cap)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    base = tv.traverse(m, idx.node_table, idx.leaf_items, fn.roots, fn.sk, fn.sk_exact, fn.pmax,
                       idx.max_leaf, q_cap=fn.q_cap, l_cap=fn.l_cap)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1] + 3)


def _full_forest(rng, n_trees, depth, wide, n_slots):
    """Full binary trees of ``depth`` split levels (numpy, no index):
    split planes drawn from 256, leaves of 1 up to ``wide`` slots, the
    first leaf of each tree at exactly ``wide``.  Returns node_table
    [N, 8] int32, leaf_items (padded by w = wide), roots, the number of
    splits and of split planes."""
    from arroy_tpu_torch.models.forest import KIND_LEAF

    rows, csr = [], []

    def node(level, first):
        nid = len(rows)
        rows.append(None)
        if level == depth:
            cnt = wide if first else int(rng.integers(1, wide + 1))
            rows[nid] = (KIND_LEAF, 0, 0, nid, len(csr), cnt)
            csr.extend(rng.integers(0, n_slots, cnt).tolist())
        else:
            left, right = node(level + 1, first), node(level + 1, False)
            rows[nid] = (0, left, right, int(rng.integers(0, 256)), 0, 0)
        return nid

    roots = [node(0, True) for _ in range(n_trees)]
    nt = np.zeros((len(rows), 8), np.int32)
    nt[:, :6] = np.asarray(rows, np.int32)
    leaf_items = np.asarray(csr + [-1] * wide, np.int32)
    return nt, leaf_items, np.asarray(roots, np.int64), int((nt[:, 0] == 0).sum()), 256


def _queue_peak(margins, nt, roots):
    """The most entries one query's queue holds when every node pops
    (a host best-first walk on (distance, node id))."""
    import heapq

    heap = [(-np.inf, -int(r)) for r in roots]
    heapq.heapify(heap)
    peak = len(heap)
    while heap:
        nd, nn = heapq.heappop(heap)
        kind, left, right, ptr = (int(v) for v in nt[-nn, :4])
        if kind == 0:
            d, m = np.float32(-nd), margins[ptr]
            heapq.heappush(heap, (-min(d, -m), -left))
            heapq.heappush(heap, (-min(d, m), -right))
        peak = max(peak, len(heap))
    return peak


@pytest.mark.parametrize("smem_lanes", [64, None])
def test_cuda_traverse_kernel_deep_heap(monkeypatch, smem_lanes):
    """Every node of 4 full trees of 11 split levels pops (search_k past
    every slot, so the queue empties and pops reach pmax): the queue holds
    up to 658 keys, past 4 full levels of the 8-ary heap (585) into a
    partial fifth, in shared memory and spilled after 64 slots."""
    from arroy_tpu_torch.ops import traverse as tv

    dev = require_cuda()
    rng = np.random.default_rng(11)
    nt, leaf_items, roots, n_splits, s_rows = _full_forest(rng, 4, 11, 3, 64)
    margins = rng.standard_normal((64, s_rows)).astype(np.float32)
    assert _queue_peak(margins[0], nt, roots) > 1 + 8 + 64 + 512
    if smem_lanes is not None:
        monkeypatch.setattr(tv, "SMEM_LANES", smem_lanes)
    t, total = len(roots), int(leaf_items.shape[0]) - 3
    args = [torch.from_numpy(a).to(dev) for a in (margins, nt, leaf_items, roots)]
    args += [total + 1, total + 1, len(nt) + t + 1, 3]
    kw = dict(q_cap=t + n_splits + 1, l_cap=len(nt))
    got = tv.traverse(*args, **kw)
    want = tv.traverse_reference(*args, **kw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert bool((got[1] == len(nt) + t + 1).all()) and bool((got[2] == total).all())


def test_cuda_traverse_kernel_full_window_filtered():
    """Filtered leaf windows at max_leaf = 800 slots (two rounds of the
    kernel's 24 chunks of 32 items; a leaf of 768 is one round), half the
    slots accepted, search_k past half the forest; at the first search_k
    the node table has 6 columns (the wrapper pads it to the kernel's 8)."""
    from arroy_tpu_torch.ops import traverse as tv

    dev = require_cuda()
    rng = np.random.default_rng(12)
    nt, leaf_items, roots, n_splits, s_rows = _full_forest(rng, 3, 5, 800, 4096)
    margins = rng.standard_normal((65, s_rows)).astype(np.float32)
    words = np.zeros(4096 // 32, np.uint32)
    acc = np.flatnonzero(rng.random(4096) < 0.5)
    np.bitwise_or.at(words, acc >> 5, np.uint32(1) << (acc & 31).astype(np.uint32))
    t = len(roots)
    n0 = tv.launches["traverse"]
    for sk in (768, 8192, 16384):
        table = np.ascontiguousarray(nt[:, :6]) if sk == 768 else nt
        args = [torch.from_numpy(a).to(dev) for a in (margins, table, leaf_items, roots)]
        args += [sk, sk, len(nt) + t + 1, 800]
        kw = dict(q_cap=t + n_splits + 1, l_cap=min(sk, len(nt)) + 1,
                  filter_words=torch.from_numpy(words.view(np.int32)).to(dev))
        got = tv.traverse(*args, **kw)
        want = tv.traverse_reference(*args, **kw)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
        assert int(got[2].min()) > 0
    assert tv.launches["traverse"] == n0 + 3


@pytest.mark.parametrize("metric", [
    "euclidean", "cosine", "dot-product", "manhattan",
    "binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine",
])
def test_cuda_traverse_kernel_all_metrics(metric):
    """Each metric's own margins (BQ margins are integer-valued: many
    ties), unfiltered and filtered."""
    for filtered in (False, True):
        fn, m = _kernel_fn(metric, 600, 65, filtered)
        _kernel_vs_plain(fn, m, fn.pmax, fn.q_cap)


def test_cuda_traverse_kernel_rejects():
    from arroy_tpu_torch.ops import traverse as tv

    fn, m = _kernel_fn("euclidean", 64, 1, False)
    idx = fn.idx
    args = [m, idx.node_table, idx.leaf_items, fn.roots, fn.sk, fn.sk_exact, fn.pmax, idx.max_leaf]

    def call(**swap):
        a = list(args)
        for i, v in swap.items():
            a[int(i[1:])] = v
        return tv.traverse(*a, q_cap=fn.q_cap, l_cap=fn.l_cap)

    with pytest.raises(ValueError, match="one device"):
        call(a1=idx.node_table.cpu())
    with pytest.raises(ValueError, match="one device"):
        call(a3=fn.roots.cpu())
    with pytest.raises(TypeError, match="float32"):
        call(a0=m.double())
    with pytest.raises(TypeError, match="int32"):
        call(a1=idx.node_table.long())
    with pytest.raises(TypeError, match="int32"):
        tv.traverse(*args, q_cap=fn.q_cap, l_cap=fn.l_cap,
                    filter_words=torch.zeros(4, dtype=torch.int64, device=m.device))
    with pytest.raises(ValueError, match="q_cap"):
        tv.traverse(*args, q_cap=len(fn.roots) - 1, l_cap=fn.l_cap)


def _force_scan(monkeypatch, **more):
    """Every batch streams (a 1-byte matrix budget), in chunks of 1,024
    items: 6,000 items make five full chunks and a ragged sixth."""
    from arroy_tpu_torch import search as t_search

    monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 1)
    monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 1024)
    for name, value in more.items():
        monkeypatch.setattr(t_search, name, value)
    return t_search


@pytest.mark.parametrize("metric,precision", [
    ("euclidean", "f32x1"), ("cosine", "f32x1"), ("dot-product", "f32x1"), ("euclidean", "f32"),
    ("euclidean", "bf16"), ("cosine", "int8"),
])
def test_cuda_exact_scan_matches_cpu(tmp_path, monkeypatch, metric, precision):
    """The streaming scan on the card against the same index scanned on the
    CPU: f32 modes tie-aware at rtol 1e-5; the int8 and bf16 modes (the
    unfused route, forced by a zero fused-table cap) scan bf16 rows on
    cuBLAS and recall >= 0.99 of the CPU's ids.  Under the matrix budget
    again, the unfused route caches int8 rows (int32-accumulating GEMM)
    or bf16 rows, and still recalls >= 0.99 of the CPU's ids."""
    gr, cr, q = _traversal_pair(tmp_path, metric)
    t_search = _force_scan(monkeypatch, _FUSED_TABLE_BYTES=0)
    gs_, cs_ = (r.searcher(10, engine="exact", precision=precision) for r in (gr, cr))
    assert gs_.route == ("unfused" if precision in ("bf16", "int8") else precision)
    n0 = t_search.scan_calls["exact_scan"]
    ids, d = _result_arrays(gs_.device_fn(*gs_.prepare_queries(q)))
    assert t_search.scan_calls["exact_scan"] == n0 + 1
    rids, rd = _result_arrays(cs_.device_fn(*cs_.prepare_queries(q)))
    if precision.startswith("f32"):
        tie_aware_equal(ids, d, rids, rd, rtol=1e-5, atol=1e-6)
    else:
        assert recall(ids, rids) >= 0.99
        monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 4 << 30)
        n1 = t_search.scan_calls["exact_scan"]
        ids, _ = _result_arrays(gs_.device_fn(*gs_.prepare_queries(q)))
        assert t_search.scan_calls["exact_scan"] == n1
        want = {"int8": (torch.int8, torch.float32), "bf16": (torch.bfloat16,)}[precision]
        assert tuple(t.dtype for t in gs_.device_fn.quant) == want
        assert all(t.device.type == "cuda" for t in gs_.device_fn.quant)
        assert recall(ids, _result_arrays(cs_.device_fn(*cs_.prepare_queries(q)))[0]) >= 0.99


@pytest.mark.parametrize("metric", [
    "binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine"])
def test_cuda_bq_scan_matches_cpu(tmp_path, monkeypatch, metric):
    """The BQ scan on the card: distances bit-equal to the CPU's scan and
    to the card's own matrix, ids tie-aware; kernel 2 is launched once a
    chunk (6 a batch)."""
    gr, cr, q = _traversal_pair(tmp_path, metric, d=256)
    s = gr.searcher(10, engine="exact")
    mids, md = _result_arrays(s.device_fn(*s.prepare_queries(q)))
    t_search = _force_scan(monkeypatch)
    gs_, cs_ = (r.searcher(10, engine="exact") for r in (gr, cr))
    n0, h0 = t_search.scan_calls["bq_scan"], bq_kernels.launches["bq_hamming"]
    ids, d = _result_arrays(gs_.device_fn(*gs_.prepare_queries(q)))
    assert t_search.scan_calls["bq_scan"] == n0 + 1
    assert bq_kernels.launches["bq_hamming"] == h0 + 6
    tie_aware_equal(ids, d, *_result_arrays(cs_.device_fn(*cs_.prepare_queries(q))), rtol=0, atol=0)
    tie_aware_equal(ids, d, mids, md, rtol=0, atol=0)


@pytest.mark.parametrize("m,w,s,e", [
    (20_000, 24, 4_096, 8_192), (20_000, 24, 16_384, 20_000), (3_000, 6, 1, 1_025), (3_000, 2, 3, 2_999),
])
def test_cuda_hamming_on_a_chunk_view(m, w, s, e):
    """Kernel 2 on a row slice of a larger contiguous tensor, as the BQ scan
    calls it: the counts equal the plain version's on the same view and the
    columns [s, e) of the whole matrix.  With w = 6 and 2 the view starts
    24 bytes past a 16-byte boundary."""
    dev = require_cuda()
    rng = np.random.default_rng(m + w + s)
    q, x = _hamming_words(dev, 70, w, rng), _hamming_words(dev, m, w, rng)
    view = x[s:e]
    assert view.is_contiguous() and (view.data_ptr() % 16 != 0) == (w < 8)
    got = bq_kernels.bq_hamming_matrix(q, view)
    assert torch.equal(got, bq_kernels.bq_hamming_matrix_reference(q, view))
    assert torch.equal(got, bq_kernels.bq_hamming_matrix(q, x)[:, s:e])


@pytest.mark.parametrize("metric,precision,counter", [
    ("euclidean", "f32x1", "exact_scan"), ("binary quantized cosine", "auto", "bq_scan")])
def test_cuda_one_searcher_chooses_the_matrix_or_the_scan_per_batch(tmp_path, monkeypatch, metric,
                                                                    precision, counter):
    """A budget that holds 16 queries' matrix: one searcher serves a batch
    of 16 by the matrix and one of 64 by the scan, with the same results
    for the 16 queries both served (f32 at rtol 1e-5, BQ bit-equal)."""
    from arroy_tpu_torch import search as t_search

    gr, _, q = _traversal_pair(tmp_path, metric, d=256 if "binary" in metric else 48)
    monkeypatch.setattr(t_search, "_EXACT_DOTS_BYTES", 16 * 6000 * 4)
    monkeypatch.setattr(t_search, "_EXACT_SCAN_CHUNK", 1024)
    s = gr.searcher(10, engine="exact", precision=precision)
    n0 = dict(t_search.scan_calls)
    small = _result_arrays(s.device_fn(*s.prepare_queries(q[:16])))
    assert t_search.scan_calls == n0
    ids, d = _result_arrays(s.device_fn(*s.prepare_queries(q)))
    assert t_search.scan_calls == {**n0, counter: n0[counter] + 1}
    tol = dict(rtol=0, atol=0) if "binary" in metric else dict(rtol=1e-5, atol=1e-6)
    tie_aware_equal(ids[:16], d[:16], *small, **tol)


@pytest.mark.parametrize("engine,precision", [
    ("exact", "f32x1"), ("exact", "f32"), ("exact", "bf16"), ("exact", "int8"), ("forest", "exact"),
])
def test_cuda_serving_bf16_matches_cpu(tmp_path, monkeypatch, engine, precision):
    """ARROY_SERVING_DTYPE=bf16: the rows are bf16 on the card, every exact
    mode serves from them (bf16 GEMMs with f32 sums; the fused tables made
    from bf16 rows), as does the traversal's exact re-score (on the CPU's
    margins), against the same index served bf16 on the CPU: f32 modes and
    the traversal tie-aware at rtol 1e-5, the fused modes at recall 0.99."""
    monkeypatch.setenv("ARROY_SERVING_DTYPE", "bf16")
    gr, cr, q = _traversal_pair(tmp_path)
    if engine == "exact":
        gs_, cs_ = (r.searcher(10, engine="exact", precision=precision) for r in (gr, cr))
        assert gs_._dev.rows.dtype == cs_._dev.rows.dtype == torch.bfloat16
        got = _result_arrays(gs_.device_fn(*gs_.prepare_queries(q)))
        want = _result_arrays(cs_.device_fn(*cs_.prepare_queries(q)))
    else:
        kw = dict(search_k=2000, engine="forest", traversal="xla", rescore=precision)
        gs_, cs_ = gr.searcher(10, **kw), cr.searcher(10, **kw)
        assert gs_._dev.rows.dtype == torch.bfloat16
        cq = cs_.prepare_queries(q)
        m = cs_.device_fn.margins(cq[0], cq[3])
        got = _result_arrays(gs_.device_fn.run(m.cuda(), *(t.cuda() for t in cq[:3])))
        want = _result_arrays(cs_.device_fn.run(m, *cq[:3]))
    if precision in ("bf16", "int8"):
        assert gs_.route == "fused_select"
        assert recall(got[0], want[0]) >= 0.99
    else:
        tie_aware_equal(*got, *want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the incremental build: the patched device mirror, the delete pass and the
# routing on the card
# ---------------------------------------------------------------------------

ALL_METRICS = (
    "euclidean", "cosine", "dot-product", "manhattan",
    "binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine",
)


def _host_arrays(s):
    rows = s.rows().view(np.int32) if s.metric.binary else s.rows()
    return rows, s.norms(), s.extras()


def _mirror_matches(s, dev):
    from arroy_tpu_torch.models import items

    got = s.device_arrays(dev)
    assert all(t.device.type == "cuda" for t in got)
    for t, h in zip(got, _host_arrays(s)):
        np.testing.assert_array_equal(t.cpu().numpy(), h)
    return items.mirror_rows_uploaded


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized cosine"])
def test_cuda_mirror_patch_matches_fresh_upload(metric):
    """The mirror on the card, patched after puts, deletes, growth in
    capacity and clone divergence, equals the host arrays (a fresh upload)."""
    from arroy_tpu_torch.metrics import resolve_metric
    from arroy_tpu_torch.models.items import ItemStore

    dev = require_cuda()
    s = ItemStore(resolve_metric(metric), 96)
    rng = np.random.default_rng(3)
    s.put_many(np.arange(200), rng.standard_normal((200, 96)).astype(np.float32))
    assert _mirror_matches(s, dev) == s.capacity()
    s.put(2, rng.standard_normal(96).astype(np.float32))
    s.delete(7)
    assert _mirror_matches(s, dev) == 2
    cap = s.capacity()
    s.put_many(np.arange(1000, 1000 + cap - 199), rng.standard_normal((cap - 199, 96)).astype(np.float32))
    s.device_arrays(dev)
    s.put_many(np.arange(5000, 5010), rng.standard_normal((10, 96)).astype(np.float32))
    assert s.capacity() > cap and _mirror_matches(s, dev) == 10
    a, b = s.clone(), s.clone()
    a.put(0, np.ones(96, np.float32))
    assert _mirror_matches(a, dev) == 1
    b.put(0, np.full(96, 2.0, np.float32))
    assert _mirror_matches(b, dev) == b.capacity()


def _forests_equal(a, b):
    for f in ("kind", "left", "right", "ptr", "normals", "aux"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.roots == b.roots and sorted(a.leaves) == sorted(b.leaves)
    for nid, ids in a.leaves.items():
        np.testing.assert_array_equal(ids, b.leaves[nid])


def test_cuda_delete_only_build_matches_cpu(tmp_path):
    """A delete-only incremental build (no random draw) gives the same
    forest on the card as on the CPU, from the same files."""
    import shutil

    dev = require_cuda()
    x = np.random.default_rng(5).standard_normal((3000, 32)).astype(np.float32)
    db = Database(str(tmp_path / "a"), device="cpu")
    w = Writer(db, 0, 32)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(3000), x)
        w.builder(seed=1).n_trees(4).split_after(16).build(wtxn)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    forests = []
    for path, device in ((tmp_path / "a", "cpu"), (tmp_path / "b", dev)):
        db = Database(str(path), device=device)
        w = Writer(db, 0, 32)
        with db.write() as wtxn:
            w.del_items(wtxn, np.arange(0, 3000, 3))
            w.builder(seed=2).n_trees(4).split_after(16).build(wtxn)
        r = Reader.open(db.read(), 0, db)
        r.assert_validity()
        forests.append(r._state.forest)
    _forests_equal(*forests)


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_cuda_route_items_matches_cpu(metric):
    """`route_items` on the card lands every lane where the CPU does, but
    for lanes whose path meets a margin under the sums' rounding (the two
    devices sum in other orders), which must be few; a split without a
    normal takes the same threefry coin on both devices."""
    from arroy_tpu_torch import builder, prng
    from arroy_tpu_torch.models.forest import KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE, NodeIdAllocator

    dev = require_cuda()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4000, 48)).astype(np.float32)
    db = Database(None, device="cpu")
    w = Writer(db, 0, 48, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(3000), x[:3000])
        w.builder(seed=3).n_trees(4).split_after(24).build(wtxn)
    with db.write() as wtxn:  # fresh items, not yet in any tree
        w.add_items(wtxn, np.arange(3000, 4000), x[3000:])
        st = wtxn.state(0)
        slots = st.store.slots_of(np.arange(4000))
        f = st.forest
        routed = []
        for device in ("cpu", dev):
            rows, norms, extras = st.store.device_arrays(device)
            ctx = builder.BuildContext(
                metric=st.metric, dims=48, split_after=24, device=torch.device(device),
                rows_dev=rows, extras_dev=extras, hnorms_dev=norms,
                slot_to_id=st.store.slot_ids(), forest=f,
                alloc=NodeIdAllocator(f.used_node_ids()), staging_normals=[f.normals],
                staging_aux=[np.asarray(f.aux, np.float32)], staging_rows=len(f.aux),
            )
            out = builder.route_items(ctx, ctx.staging_matrix_dev(), ctx.staging_aux_np(),
                                      [(r, slots) for r in f.roots], prng.key(0))
            leaf = {}
            for nid, ls in out.items():
                assert f.kind[nid] == KIND_LEAF
                for s_ in np.concatenate(ls).tolist():
                    leaf.setdefault(s_, []).append(nid)
            routed.append({k: sorted(v) for k, v in leaf.items()})
        wtxn.abort()
    cpu, card = routed
    assert sorted(cpu) == sorted(card) == sorted(slots.tolist())
    differ = [s_ for s_ in cpu if cpu[s_] != card[s_]]
    # walk each differing lane's CPU path in every tree: it must meet a
    # split whose |margin| is within 1e-5 of the sum of its terms'
    # magnitudes (binary metrics: exact integer sums, so none may differ)
    rows, _, extras = st.store.device_arrays("cpu")
    normals = torch.from_numpy(f.normals.view(np.int32) if st.metric.binary else f.normals)
    why = {"near": 0, "none": 0}
    for s_ in differ:
        seen = set()
        for root in f.roots:
            nid = root
            while f.kind[nid] != KIND_LEAF:
                if f.kind[nid] == KIND_SPLIT_NONE:  # the side the CPU's coin took
                    under, stack = set(), [int(f.left[nid])]
                    while stack:
                        u = stack.pop()
                        under.add(u)
                        if f.kind[u] != KIND_LEAF:
                            stack += [int(f.left[u]), int(f.right[u])]
                    nid = int(f.left[nid]) if under & set(cpu[s_]) else int(f.right[nid])
                    continue
                n, a_ = normals[f.ptr[nid]], float(f.aux[f.ptr[nid]])
                v = rows[s_]
                qf = float(extras[s_]) if st.metric.has_extra else 1.0
                m = float(st.metric.margin(n, torch.tensor(a_), v, qf))
                if not st.metric.binary:
                    if abs(m) <= 1e-5 * (float((n.abs() * v.abs()).sum()) + abs(a_ * qf)):
                        seen.add("near")
                nid = int(f.left[nid]) if np.signbit(m) else int(f.right[nid])
        why["near" if "near" in seen else "none"] += 1
    assert why["none"] == 0, f"{len(differ)} lanes differ: {why}"
    assert why["near"] <= 0.01 * len(slots), why


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized cosine"])
def test_cuda_budget_build_keeps_the_invariants(metric):
    from arroy_tpu_torch import writer
    from arroy_tpu_torch.metrics import resolve_metric
    from arroy_tpu_torch.models.forest import KIND_LEAF

    dev = require_cuda()
    sd = resolve_metric(metric).storage_dim(64)
    x = np.random.default_rng(9).standard_normal((5000, 64)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, 64, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(5000), x)
        w.builder(seed=4).n_trees(5).split_after(32).available_memory(600 * (4 + 4 * sd)).build(wtxn)
    assert writer.build_stats["streaming"] and writer.build_stats["valve_items"] == 0
    r = Reader.open(db.read(), 0, db, metric=metric)
    r.assert_validity()
    f = r._state.forest
    assert r.n_trees() == 5
    assert max(len(f.leaves[int(n)]) for n in np.nonzero(f.kind == KIND_LEAF)[0]) <= 32


def test_cuda_profiling_trace_names_kernel_1(tmp_path):
    """`utils.profiling.trace` around one exact batch records kernel 1's
    CUDA function by name, in the profiler's tables and in the trace file,
    under the program's span of stage 1 (``arroy.exact.select``), which
    adds no event on the card."""
    import os

    from arroy_tpu_torch.utils import profiling

    dev = require_cuda()
    x = np.random.default_rng(5).standard_normal((8192, 128)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, 128)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(8192), x)
        w.builder(seed=1).n_trees(2).build(wtxn)
    s = Reader.open(db.read(), 0, db).searcher(10)
    assert s.route == "fused_select"
    dq = s.prepare_queries(x[:256])
    s.device_fn(*dq)
    n0 = fused_select.launches["fused_select_bf16"]
    with profiling.trace(str(tmp_path)) as prof:
        ids, _ = s.device_fn(*dq)
    assert fused_select.launches["fused_select_bf16"] == n0 + 1
    assert np.array_equal(ids[:, 0].cpu().numpy(), np.arange(256))
    assert any("fused_select_kernel" in e.key for e in prof.key_averages())
    assert not any(e.name.startswith("arroy.") for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        text = f.read()
    assert "fused_select_kernel" in text and '"arroy.exact.select"' in text


def test_cuda_counting_records_each_kernel(monkeypatch):
    """`utils.profiling.counting` around one request of each engine on the
    card: one work record a launch of kernels 3, 4, 5 and 6, each holding the
    work its inputs set, and the answers of the request outside it.  The
    probe's stage 1 is forced onto kernel 6: the route rule sends a table
    this small to the plain chain."""
    from arroy_tpu_torch.ops import rank_select, rescore, traverse
    from arroy_tpu_torch.utils import profiling

    dev = require_cuda()
    monkeypatch.setattr(rank_select, "uses_kernel", lambda *_a: True)
    x = np.random.default_rng(6).standard_normal((20_000, 64)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, 64, metric="cosine")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=2).n_trees(8).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="cosine")
    q = x[:512] + 0.01
    engines = {
        "exact": (r.searcher(10), {"cut_rescore"}),
        "traversal": (r.searcher(10, search_k=2000, engine="forest", traversal="xla",
                                  rescore="exact"), {"traverse", "rescore_topk"}),
        "probe": (r.searcher(10, search_k=2000, engine="forest", traversal="probe",
                              probe_trees=4), {"rank_select", "gather_score", "rescore_topk"}),
    }
    for name, (s, kernels) in engines.items():
        dq = s.prepare_queries(q)
        ids, d = s.device_fn(*dq)
        n0 = {**gs.launches, **traverse.launches, **rescore.launches, **rank_select.launches}
        with profiling.counting() as works:
            ids2, d2 = s.device_fn(*dq)
        n1 = {**gs.launches, **traverse.launches, **rescore.launches, **rank_select.launches}
        assert torch.equal(ids, ids2) and torch.equal(d, d2), name
        assert {x["kernel"] for x in works} == kernels, name
        launched = {k.rpartition("_")[0] if k.startswith("gather") else k: n1[k] - n0[k]
                    for k in n1 if n1[k] > n0[k]}
        assert launched == {k: sum(x["kernel"] == k for x in works) for k in kernels}, name
        for rec in works:
            assert rec["B"] == len(q)
            if rec["kernel"] == "traverse":
                assert rec["pops_total"] == int(s.device_fn.last_pops.sum())
                assert rec["pops_max"] == int(s.device_fn.last_pops.max())
            elif rec["kernel"] == "gather_score":
                assert 0 < rec["blocks"] <= min(rec["B"] * rec["C"], len(s.device_fn.tables.valid))
            elif rec["kernel"] == "rank_select":
                t = s.device_fn.tables
                assert (rec["T"], rec["nb_max"], rec["L"], rec["d"], rec["route"]) == (
                    t.n_trees, t.nb_max, s.device_fn.L, 64, "kernel")
            else:
                assert 0 < rec["rows"] <= min(rec["valid"], len(x))
                assert rec["valid"] <= rec["B"] * rec["c"]


def test_cuda_upgraded_index_search_matches_cpu(tmp_path):
    """The committed 1.1 asset upgraded by the port: the exact engine and
    the traversal on the card answer as on the CPU."""
    import os
    import shutil

    from arroy_tpu_torch.upgrade import upgrade_all

    dev = require_cuda()
    path = str(tmp_path / "db")
    shutil.copytree(os.path.join(os.path.dirname(__file__), "assets", "v1_1_zero_normal"), path)
    assert upgrade_all(Database(path, device=dev)) == [0, 1]
    for idx, metric in ((0, "euclidean"), (1, "binary quantized cosine")):
        out = {}
        for d in (dev, "cpu"):
            db = Database(path, device=d)
            r = Reader.open(db.read(), idx, db, metric=metric)
            assert str(r.version()) == "1.2.0"
            q = np.stack([r.item_vector(i) for i in r.item_ids()])[:32]
            for engine in ("exact", "forest"):
                res = r.searcher(10, engine=engine)(q)
                out[d, engine] = (np.array([[i for i, _ in row] for row in res]),
                                  np.array([[v for _, v in row] for row in res]))
        for engine in ("exact", "forest"):
            tie_aware_equal(*out[dev, engine], *out["cpu", engine], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the multi-device layer (`parallel/`) on one card
# ---------------------------------------------------------------------------


def _single_index(dev, m=6000, d=64, metric="euclidean", seed=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, d, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m), x)
        w.builder(seed=3).n_trees(4).build(wtxn)
    q = x[rng.integers(m, size=64)] + 0.3 * rng.standard_normal((64, d)).astype(np.float32)
    return Reader.open(db.read(), 0, db, metric=metric), x, q


def test_cuda_one_shard_equals_unsharded_engine():
    """A 1-shard mesh on the card answers as the unsharded engines do:
    the exact f32x1 engine, the traversal and the probe (kernel 3)."""
    from arroy_tpu_torch.device import DeviceIndex
    from arroy_tpu_torch.parallel.forest import ShardedForestIndex
    from arroy_tpu_torch.parallel.mesh import ShardedExactIndex, make_mesh

    dev = require_cuda()
    r, x, q = _single_index(dev)
    mesh = make_mesh(1)
    ids, d = ShardedExactIndex(mesh, x).search(q, 10)
    tie_aware_equal(ids, d, *_result_arrays_of(r.searcher(10, engine="exact", precision="f32x1")(q)),
                    rtol=1e-5, atol=1e-6)
    st = r._state
    sf = ShardedForestIndex(mesh, [DeviceIndex.build_np(r.metric, 64, st.store, st.forest)],
                            "euclidean", 64, states=[st])
    want = r.searcher(10, search_k=800, engine="forest", traversal="xla", rescore="exact")(q)
    tie_aware_equal(*sf.search(q, 10, search_k=800), *_result_arrays_of(want), rtol=1e-5, atol=1e-6)
    n0 = gs.launches["gather_score_bf16"]
    got = sf.probe_search(q, 10, search_k=800, n_trees=4, block=16, dtype="bf16")
    assert gs.launches["gather_score_bf16"] > n0
    want = r.searcher(10, search_k=800, engine="forest", traversal="probe", probe_trees=4,
                      probe_block=16, probe_dtype="bf16")(q)
    tie_aware_equal(*got, *_result_arrays_of(want), rtol=1e-5, atol=1e-6)


def test_cuda_four_shards_equal_cpu():
    """4 shards sharing the card answer as 4 shards on the CPU: the exact
    index, the traversal on the same margins, and the probe at an
    exhaustive budget (every candidate re-scored, so kernel 3's summation
    order cannot move a result)."""
    from arroy_tpu_torch.parallel.forest import ShardedForestIndex
    from arroy_tpu_torch.parallel.mesh import ShardedExactIndex, make_mesh, merge_topk

    require_cuda()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5000, 48)).astype(np.float32)
    q = x[:32] + 0.3 * rng.standard_normal((32, 48)).astype(np.float32)
    gm, cm = make_mesh(4), make_mesh(4, device="cpu")
    for metric in ("euclidean", "binary quantized cosine"):
        g = ShardedExactIndex(gm, x, metric=metric).search(q, 10)
        tie_aware_equal(*g, *ShardedExactIndex(cm, x, metric=metric).search(q, 10),
                        rtol=1e-5, atol=1e-6)
    cf = ShardedForestIndex.build(cm, x, n_trees=3, seed=2)
    gf = ShardedForestIndex(gm, [_pack_of(st) for st in cf._states], "euclidean", 48,
                            states=cf._states)
    plan = cf.plan(10, 600)
    parts = {True: [], False: []}
    for s in range(4):
        cq = cf._queries(q, s)
        margins = cf.metric.margin_matrix(cf.shards[s].normals, cf.shards[s].aux, cq[0], cq[3])
        parts[False].append(cf.shard_search(s, plan, *cq, margins=margins))
        parts[True].append(gf.shard_search(s, plan, *gf._queries(q, s), margins=margins.cuda()))
    got = [_as_arrays(*merge_topk(cf.metric, 48, 10, parts[on], "cpu")) for on in (True, False)]
    tie_aware_equal(*got[0], *got[1], rtol=1e-5, atol=1e-6)
    kw = dict(search_k=10**6, n_trees=3, block=16, dtype="bf16")
    tie_aware_equal(*gf.probe_search(q, 10, **kw), *cf.probe_search(q, 10, **kw),
                    rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "dot-product"])
def test_cuda_mesh_build_invariant(metric):
    """One forest built on the card over 1 and over 4 shards: bit for bit."""
    from arroy_tpu_torch.parallel.mesh import make_mesh

    dev = require_cuda()
    x = np.random.default_rng(6).standard_normal((20_000, 96)).astype(np.float32)
    forests = []
    for n in (1, 4):
        db = Database(None, device=dev)
        w = Writer(db, 0, 96, metric=metric)
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(20_000), x)
            w.builder(seed=8).n_trees(3).mesh(make_mesh(n)).build(wtxn)
        Reader.open(db.read(), 0, db, metric=metric).assert_validity()
        forests.append(db.read().state(0).forest)
    a, b = forests
    for key in ("kind", "left", "right", "ptr", "normals", "aux"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    assert a.roots == b.roots and set(a.leaves) == set(b.leaves)
    assert all(np.array_equal(a.leaves[k], b.leaves[k]) for k in a.leaves)


def _pack_of(st):
    from arroy_tpu_torch.device import DeviceIndex

    return DeviceIndex.build_np(st.metric, st.dims, st.store, st.forest)


def _as_arrays(ids, d):
    return ids.cpu().numpy(), np.nan_to_num(d.cpu().numpy())


def _result_arrays_of(results):
    ids = np.array([[i for i, _ in row] for row in results])
    d = np.array([[v for _, v in row] for row in results])
    return ids, d


@pytest.mark.parametrize("name", sorted(torch_golden.scenarios()))
def test_cuda_builds_print_the_goldens(name):
    """The committed goldens, built on the card: the same threefry stream,
    the same bytes as on the CPU."""
    dev = require_cuda()
    assert torch_golden.scenarios()[name](dev) == torch_golden.snapshot(name)


def test_cuda_prng_matches_cpu():
    """Every `prng` primitive bit-equal on the card and on the CPU."""
    from arroy_tpu_torch import prng

    dev = require_cuda()

    def draws(d):
        c = torch.arange(1 << 18, dtype=torch.int64, device=d) * 2654435761 % (1 << 32)
        keys = prng.fold_in(prng.as_tensor(prng.key(9), d)[None, :].expand(len(c), 2), c)
        return [keys, prng.split(keys), prng.bits_at(keys, c),
                prng.randint(keys, (), 0, c % 70_000 + 1), prng.bernoulli_at(keys, c),
                prng.uniform(keys[0], (1 << 18,)).view(torch.int32)]

    for a, b in zip(draws(dev), draws("cpu")):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# kernel 5: the exact engine's stage 2 (key cut, re-score, top-k)
# ---------------------------------------------------------------------------


def _stage2_inputs(dev, metric, b, cap, d, dtype="f32", live_share=0.95, seed=0, zero_rows=False):
    """Rows [cap, d] (f32 or bf16), norms, ids, a live mask, and queries
    near rows (so the re-scored distances spread), all on `dev`; with
    `zero_rows`, every 97th row zero (cosine: |x|·|q| under epsilon)."""
    from arroy_tpu_torch.metrics import metric_by_name

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, d)).astype(np.float32)
    if zero_rows:
        x[::97] = 0.0
    q = x[rng.integers(cap, size=b)] + 0.3 * rng.standard_normal((b, d)).astype(np.float32)
    rows = torch.from_numpy(x)
    if dtype == "bf16":
        rows = rows.to(torch.bfloat16)
    norms = np.linalg.norm(rows.float().numpy(), axis=1).astype(np.float32)
    s2i = (rng.permutation(cap).astype(np.int64) * 3 + 7)
    live = rng.random(cap) < live_share
    return dict(
        metric=metric_by_name(metric), dims=d, rows=rows.to(dev), norms=torch.from_numpy(norms).to(dev),
        extras=torch.zeros(cap, device=dev), slot_to_id=torch.from_numpy(s2i).to(dev),
        live=torch.from_numpy(live).to(dev), qv=torch.from_numpy(q).to(dev),
        qn=torch.from_numpy(np.linalg.norm(q, axis=1).astype(np.float32)).to(dev),
        qe=torch.zeros(b, device=dev), rng=rng,
    )


def _cut_inputs(s, b, n2, dead_share=0.05, ties=False):
    """Kernel 1's outputs as the cut sees them: [B, n2] int32 keys (a share
    dead, at or below DEAD_KEY_MAX) and distinct positions per query into a
    table of Mp = cap rounded up to 256 rows; positions past cap alias
    slot 0 and carry dead keys, as padding does.  With `ties`, every query
    reads the same positions and each run of 8 of them shares one key and
    one slot, so the c-th key is tied and every choice among the ties
    gives the same candidates."""
    rng, dev, cap = s["rng"], s["qv"].device, s["rows"].shape[0]
    mp = -(-cap // 256) * 256
    p2s = np.zeros(mp, np.int64)
    p2s[:cap] = rng.permutation(cap)
    keys = rng.integers(DEAD_KEY_MAX + 1, 2**31, size=(b, n2), dtype=np.int64)
    dead = rng.random((b, n2)) < dead_share
    keys[dead] = DEAD_KEY_MAX - rng.integers(0, 1 << 20, size=int(dead.sum()))
    off = np.zeros((b, 1), np.int64) if ties else rng.integers(mp, size=(b, 1))
    idxp = (off + np.arange(n2)[None, :] * 7919) % mp
    if ties:
        run = (np.arange(n2) // 8) * 8
        keys = keys[:, run]
        p2s[idxp[0]] = p2s[idxp[0, run]]
    keys[idxp >= cap] = DEAD_KEY_MAX
    keys[-1] = DEAD_KEY_MAX  # an all-dead query
    return (torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(dev),
            torch.from_numpy(idxp.astype(np.int32)).to(dev), torch.from_numpy(p2s).to(dev))


def _check_stage2(entry, s, k, c, *args, normalize=True):
    """Kernel 5 against its plain version on one input: launched once, ids
    tie-aware equal and distances within rtol 1e-5 (f32 sums in another
    order; atol 1e-6, or for a dot product, which cancels, 1e-7 of its
    Σ|x·q| <= |x|·|q|), NaN (or +inf raw) at the same places."""
    from arroy_tpu_torch.ops import rescore as rs

    common = (s["rows"], s["norms"], s["extras"], s["slot_to_id"], s["qv"], s["qn"], s["qe"])
    kernel, plain = (rs.cut_rescore, rs.cut_rescore_reference) if entry == "cut" else (
        rs.rescore_topk, rs.rescore_topk_reference)
    name = "cut_rescore" if entry == "cut" else "rescore_topk"
    pre = (k, c) if entry == "cut" else (k,)
    n0 = rs.launches[name]
    ids, d = kernel(s["metric"], s["dims"], *pre, *args, *common, normalize=normalize)
    torch.cuda.synchronize()
    assert rs.launches[name] == n0 + 1
    rids, rd = plain(s["metric"], s["dims"], *pre, *args, *common, normalize=normalize)
    assert ids.shape == rids.shape == (s["qv"].shape[0], k) and ids.dtype == torch.int64
    d, rd = d.cpu().numpy(), rd.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(d), np.isnan(rd))
    np.testing.assert_array_equal(np.isinf(d), np.isinf(rd))
    # a raw +inf is a slot with no valid candidate: its id is unspecified
    fd, frd = (np.where(np.isinf(a), np.nan, a) for a in (d, rd))
    atol = 1e-6
    if s["metric"].name == "dot-product":
        atol = max(atol, 1e-7 * float(s["qv"].norm(dim=1).max() * s["norms"].max()))
        if normalize:  # q·x descends: negated, the row's boundary is its largest value
            fd, frd = -fd, -frd
    tie_aware_equal(ids.cpu().numpy(), fd, rids.cpu().numpy(), frd, rtol=1e-5, atol=atol)
    return ids, d


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,n2,c,k", [
    (2048, 784, 32, 10),    # the exact slice's main shape (100k items)
    (2048, 7824, 128, 10),  # 1M items
    (64, 32768, 512, 100),  # the 3 GiB table cap
    (16, 20000, 4096, 1),   # past SMEM_CANDIDATES: the scratch buffer
])
def test_cuda_cut_rescore_matches_plain(metric, dtype, b, n2, c, k):
    dev = require_cuda()
    s = _stage2_inputs(dev, metric, b, 100_000, 768, dtype)
    _check_stage2("cut", s, k, c, *_cut_inputs(s, b, n2), s["live"])


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
@pytest.mark.parametrize("d", [5, 33, 100, 768])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_cuda_cut_rescore_widths_and_ties(metric, d, k):
    """Row widths off the 16-byte loads (5, 33: one element a load; 100 f32
    is 25 vectors), runs of equal keys across the c-th key, a filtered
    live mask (a fifth live, so some queries have fewer than k valid), raw
    distances too."""
    dev = require_cuda()
    s = _stage2_inputs(dev, metric, 96, 5000, d, live_share=0.2, seed=d + k)
    c = max(2 * k, 32)
    keys, idxp, p2s = _cut_inputs(s, 96, 512, dead_share=0.3, ties=True)
    for normalize in (True, False):
        _, dist = _check_stage2("cut", s, k, c, keys, idxp, p2s, s["live"], normalize=normalize)
    assert np.isinf(dist[-1]).all(), "the all-dead query found a candidate"


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,k", [
    (2048, 40, 10),    # f32x1 at k = 10
    (2048, 128, 10),   # the scan and the f32 route at k = 10
    (256, 512, 100),
    (32, 8192, 1000),  # next_pow2(8k) at count 1000: the scratch buffer
    (4, 30_000, 1),    # f32x1 past count = cap / 4: the whole corpus
])
def test_cuda_rescore_topk_matches_plain(metric, dtype, b, c, k):
    dev = require_cuda()
    s = _stage2_inputs(dev, metric, b, 30_000, 768, dtype, live_share=0.9)
    rng = s["rng"]
    cand = np.stack([rng.choice(30_000, c, replace=False) for _ in range(b)])
    valid = s["live"].cpu().numpy()[cand] & (rng.random((b, c)) < 0.95)
    valid[-1] = False  # an all-dead query
    _check_stage2("list", s, k, c, torch.from_numpy(cand).to(dev), torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("metric,precision,route,entry", [
    ("euclidean", "int8", "fused_select", "cut_rescore"),
    ("cosine", "bf16", "fused_select", "cut_rescore"),
    ("dot-product", "f32x1", "f32x1", "rescore_topk"),
    ("euclidean", "f32", "f32", "rescore_topk"),
])
def test_cuda_searchers_launch_kernel5_once_a_batch(tmp_path, metric, precision, route, entry):
    """Each exact route ends in one launch of kernel 5 a batch, and answers
    as the same index searched on the CPU (f32 routes tie-aware at rtol
    1e-5; fused routes recall@10 >= 0.99)."""
    from arroy_tpu_torch.ops import rescore as rs

    gr, cr, q = _traversal_pair(tmp_path, metric, m=20_000, d=64)
    gs_, cs_ = (r.searcher(10, engine="exact", precision=precision) for r in (gr, cr))
    assert gs_.route == route
    n0 = dict(rs.launches)
    for _ in range(3):
        got = _result_arrays(gs_.device_fn(*gs_.prepare_queries(q)))
    assert rs.launches == {**n0, entry: n0[entry] + 3}
    want = _result_arrays(cs_.device_fn(*cs_.prepare_queries(q)))
    if route == "fused_select":
        assert recall(got[0], want[0]) >= 0.99
    else:
        tie_aware_equal(*got, *want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
@pytest.mark.parametrize("entry,b,n2,c,k,ties,regime", [
    ("list", 2048, None, 128, 10, False, "warp"),
    ("list", 2048, None, 129, 10, False, "warp"),
    ("list", 2048, None, 512, 10, False, "warp"),
    ("list", 2048, None, 513, 10, False, "block"),
    ("cut", 924, 784, 32, 10, False, "warp"),
    ("cut", 923, 784, 32, 10, False, "block"),
    ("cut", 1, 784, 32, 10, False, "block"),
    ("list", 265, None, 2048, 100, False, "block"),
    ("list", 264, None, 2048, 100, False, "block"),
    ("list", 100, None, 2048, 100, False, "block"),
    ("list", 99, None, 2048, 100, False, "split"),
    ("list", 1, None, 30_000, 10, False, "split"),
    ("list", 4, None, 30_000, 300, False, "split"),
    ("cut", 2048, 7824, 128, 10, True, "warp"),
    ("cut", 64, 32768, 512, 200, False, "block"),
    ("cut", 16, 20000, 4096, 1, True, "split"),
    ("cut", 8, 20000, 4096, 500, False, "split"),
])
def test_cuda_kernel5_regimes_match_plain(metric, entry, b, n2, c, k, ties, regime):
    """Each of kernel 5's regimes (`ops.rescore._plan`) at and around its
    boundaries: c = 128, 129 and 512 (the warp sorts of 128, 256 and 512)
    / 513, B = 924 / 923 and 1 at c = 32 (the warp regime's least batch),
    B = 265 / 264 (the block regime's register cap), 100 / 99 at c = 2,048,
    B = 1 and 4 at
    c = 30,000, the cut's split regime (each CTA selects again, positions
    as columns), runs of equal keys across the c-th, k past 128 (the
    ordered finish), cosine over zero rows; against the plain version,
    normalized and raw."""
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert rs._plan(b, c, n2, 768, k, sms).regime == regime
    s, args = _regime_inputs(dev, metric, entry, b, n2, c, k, ties)
    for normalize in (True, False):
        _check_stage2(entry, s, k, c, *args, normalize=normalize)
    assert rs.last_plan["cut_rescore" if entry == "cut" else "rescore_topk"].regime == regime


def _regime_inputs(dev, metric, entry, b, n2, c, k, ties=False):
    """`_stage2_inputs` over 100,000 x 768 (live 0.9, zero rows, seed c + k)
    and the entry's own arguments: the cut's keys, or a list of c distinct
    slots a query, 95% valid, the last query all dead."""
    s = _stage2_inputs(dev, metric, b, 100_000, 768, live_share=0.9, seed=c + k,
                       zero_rows=True)
    if entry == "cut":
        return s, (*_cut_inputs(s, b, n2, ties=ties), s["live"])
    rng = s["rng"]
    cand = np.stack([rng.choice(100_000, c, replace=False) for _ in range(b)])
    valid = s["live"].cpu().numpy()[cand] & (rng.random((b, c)) < 0.95)
    if b > 1:
        valid[-1] = False  # an all-dead query
    return s, (torch.from_numpy(cand).to(dev), torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product"])
@pytest.mark.parametrize("entry,b,n2,c,k,forced,splits", [
    ("list", 132, None, 2048, 100, "split", 2),
    ("cut", 132, 20000, 2048, 10, "split", 2),
    ("cut", 1, 784, 32, 10, "warp", 1),
    ("list", 2048, None, 513, 10, "block", 1),
])
def test_cuda_kernel5_forced_plans_match_plain(monkeypatch, metric, entry, b, n2, c, k, forced,
                                               splits):
    """Kernel 5 in a plan `ops.rescore._plan` does not pick for the shape
    (`ops.rescore._plans`), against the plain version: the split regime
    with S = 2 (no B of this card's plans gives it: a B for which two CTAs
    fill the card is past SPLIT_MAX_SHARE), a warp for one query, and the
    block regime uncapped at 2048 queries."""
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = rs._plans(b, c, n2, 768, k, sms)[forced]
    assert plan != rs._plan(b, c, n2, 768, k, sms) and plan.splits == splits
    monkeypatch.setattr(rs, "_plan", lambda *_a, **_kw: plan)
    s, args = _regime_inputs(dev, metric, entry, b, n2, c, k)
    for normalize in (True, False):
        _check_stage2(entry, s, k, c, *args, normalize=normalize)
    assert rs.last_plan["cut_rescore" if entry == "cut" else "rescore_topk"] == plan


def test_cuda_kernel5_rejects_bad_inputs():
    from arroy_tpu_torch.metrics import metric_by_name
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    s = _stage2_inputs(dev, "euclidean", 8, 1000, 16)
    keys, idxp, p2s = _cut_inputs(s, 8, 64)
    common = (s["rows"], s["norms"], s["extras"], s["slot_to_id"], s["qv"], s["qn"], s["qe"])
    n0 = dict(rs.launches)
    with pytest.raises(ValueError, match="metric"):
        rs.cut_rescore(metric_by_name("manhattan"), 16, 10, 32, keys, idxp, p2s, s["live"], *common)
    with pytest.raises(ValueError, match="k = 40"):
        rs.cut_rescore(s["metric"], 16, 40, 32, keys, idxp, p2s, s["live"], *common)
    with pytest.raises(TypeError, match="int32"):
        rs.cut_rescore(s["metric"], 16, 10, 32, keys.long(), idxp, p2s, s["live"], *common)
    cand = torch.zeros((8, 32), dtype=torch.int64, device=dev)
    valid = torch.ones((8, 32), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        rs.rescore_topk(s["metric"], 16, 10, cand.t().contiguous().t()[:, :32], valid, *common)
    with pytest.raises(TypeError, match="f32 or bf16"):
        rs.rescore_topk(s["metric"], 16, 10, cand, valid, s["rows"].half(), *common[1:])
    assert rs.launches == n0


# ---------------------------------------------------------------------------
# kernel 5 in the forest engines: the probe's stage 3, the traversal's
# re-score (nns(), small batches, the filter pool), the sharded forest
# ---------------------------------------------------------------------------


def _forest_list(s, b, c, dup_share, seed=0):
    """A forest engine's deduplicated candidate list on the card: [B, c]
    slots, sorted in each query, a share of them duplicates of another
    column and marked dead as the dedup marks them, a few more dead (slots
    the engines drop), the last query all dead."""
    rng = np.random.default_rng(seed)
    cap = s["rows"].shape[0]
    cand = np.stack([rng.choice(cap, c, replace=False) for _ in range(b)])
    dup = rng.random((b, c)) < dup_share
    cand[dup] = cand[np.nonzero(dup)[0], rng.integers(c, size=int(dup.sum()))]
    cand.sort(axis=1)
    valid = np.ones((b, c), bool)
    valid[:, 1:] = cand[:, 1:] != cand[:, :-1]
    valid &= rng.random((b, c)) < 0.97
    if b > 1:
        valid[-1] = False
    dev = s["qv"].device
    return torch.from_numpy(cand).to(dev), torch.from_numpy(valid).to(dev)


#: the forest engines' shapes (d = 768, k = 10): the probe's stage 3 at
#: B = 256 and c = k2 = 512, 1,000 and 4,000 (search_k up to 4,096, 8,000
#: and 32,000), f32 and bf16 rows, 25% duplicates; the traversal's at
#: B = 1 and 16 with c = cap = next_pow2(search_k) + max_leaf (768) at
#: search_k 2000 and 8000
FOREST_SHAPES = [
    ("euclidean", "f32", 256, 512, 0.25), ("euclidean", "bf16", 256, 512, 0.25),
    ("cosine", "f32", 256, 1000, 0.25), ("euclidean", "bf16", 256, 1000, 0.25),
    ("dot-product", "f32", 256, 4000, 0.25), ("euclidean", "bf16", 256, 4000, 0.25),
    ("euclidean", "f32", 1, 2816, 0.05), ("euclidean", "f32", 1, 8960, 0.05),
    ("euclidean", "f32", 16, 2816, 0.05), ("cosine", "f32", 16, 8960, 0.05),
]


@pytest.mark.parametrize("metric,dtype,b,c,dup", FOREST_SHAPES)
def test_cuda_kernel5_forest_shapes_every_plan(monkeypatch, metric, dtype, b, c, dup):
    """Each forest shape in every plan that can run it (`ops.rescore._plans`),
    against the plain version, normalized and raw."""
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = _stage2_inputs(dev, metric, b, 100_000, 768, dtype, live_share=1.0, seed=c)
    cand, valid = _forest_list(s, b, c, dup, seed=c)
    plans = rs._plans(b, c, None, 768, 10, sms)
    assert rs._plan(b, c, None, 768, 10, sms) in plans.values()
    for name, plan in plans.items():
        monkeypatch.setattr(rs, "_plan", lambda *_a, _p=plan, **_kw: _p)
        for normalize in (True, False):
            _check_stage2("list", s, 10, c, cand, valid, normalize=normalize)
        assert rs.last_plan["rescore_topk"] == plan, name


@pytest.fixture
def plain_forest_rescore(monkeypatch):
    """A function that runs its argument with the forest engines' plain
    chains (`forest_kernel` answering False) and counts no launch."""
    from arroy_tpu_torch import probe, search
    from arroy_tpu_torch.ops import rescore as rs

    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(probe, "forest_kernel", lambda *_a: False)
            m.setattr(search, "forest_kernel", lambda *_a: False)
            n0 = rs.launches["rescore_topk"]
            out = fn()
            assert rs.launches["rescore_topk"] == n0
        return out

    return run


def test_cuda_probe_stage3_launches_kernel5_once_a_batch(tmp_path, plain_forest_rescore):
    """The probe on the card (bf16 and int8 tables): one `rescore_topk`
    launch a batch, its answers tie-aware equal to the plain stage 3 fed
    the same stage-2 candidates."""
    from arroy_tpu_torch import probe
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    db = Database(str(tmp_path), device=dev)
    w = Writer(db, 0, 64, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=1).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    q = x[:48] + 0.3 * rng.standard_normal((48, 64)).astype(np.float32)
    for dtype in ("bf16", "int8"):
        s = r.searcher(10, search_k=4000, engine="forest", traversal="probe", probe_trees=4,
                       probe_dtype=dtype)
        assert s.route == "probe"
        dq = s.prepare_queries(q)
        seen = []
        real = probe._rescore_slots

        def record(*a):
            seen.append(a)
            return real(*a)

        probe._rescore_slots = record
        try:
            n0 = rs.launches["rescore_topk"]
            got = [s.device_fn(*dq) for _ in range(3)]
            assert rs.launches["rescore_topk"] == n0 + 3
        finally:
            probe._rescore_slots = real
        want = plain_forest_rescore(lambda: probe._rescore_slots_plain(*seen[0]))
        for ids, d in got:
            tie_aware_equal(*_result_arrays((ids, d)), *_result_arrays(want), rtol=1e-5, atol=1e-6)


def test_cuda_small_batch_traversal_launches_kernel5(tmp_path, plain_forest_rescore):
    """`nns()` (B = 1) and a forest searcher at B = 16 whose `rescore_mode`
    answers "exact", unfiltered and filtered at 10% of the ids: one launch a
    batch, answers tie-aware equal to the plain chain on the card."""
    from arroy_tpu_torch.ops import rescore as rs

    gr, _, q = _traversal_pair(tmp_path, m=20_000, d=48)
    filt = np.random.default_rng(2).choice(20_000, 2000, replace=False)
    for cand in (None, filt):
        n0 = rs.launches["rescore_topk"]
        qb = gr.nns(10).search_k(600)
        if cand is not None:
            qb = qb.candidates(cand)
        got = [qb.by_vector(v) for v in q[:8]]
        assert rs.launches["rescore_topk"] == n0 + 8
        want = plain_forest_rescore(lambda: [qb.by_vector(v) for v in q[:8]])
        tie_aware_equal(*_result_arrays_of(got), *_result_arrays_of(want), rtol=1e-5, atol=1e-6)
        s = gr.searcher(10, search_k=600, engine="forest", candidates=cand)
        assert s.route == "traversal" and s.device_fn.rescore_mode(16) == "exact"
        dq = s.prepare_queries(q[:16])
        n0 = rs.launches["rescore_topk"]
        got = _result_arrays(s.device_fn(*dq))
        assert rs.launches["rescore_topk"] == n0 + 1
        want = plain_forest_rescore(lambda: _result_arrays(s.device_fn(*dq)))
        tie_aware_equal(*got, *want, rtol=1e-5, atol=1e-6)


def test_cuda_filter_pool_launches_kernel5(tmp_path, plain_forest_rescore):
    """A filter that fits the budget is re-scored whole: one launch a batch,
    equal to the plain chain on the card and to the CPU."""
    from arroy_tpu_torch.ops import rescore as rs

    gr, cr, q = _traversal_pair(tmp_path, "cosine", m=20_000, d=48)
    cand = np.random.default_rng(3).choice(20_000, 300, replace=False)
    kw = dict(search_k=600, engine="forest", candidates=cand, rescore="exact")
    s = gr.searcher(10, **kw)
    assert s.route == "filter_pool"
    dq = s.prepare_queries(q)
    n0 = rs.launches["rescore_topk"]
    got = _result_arrays(s.device_fn(*dq))
    assert rs.launches["rescore_topk"] == n0 + 1
    tie_aware_equal(*got, *plain_forest_rescore(lambda: _result_arrays(s.device_fn(*dq))),
                    rtol=1e-5, atol=1e-6)
    cs_ = cr.searcher(10, **kw)
    tie_aware_equal(*got, *_result_arrays(cs_.device_fn(*cs_.prepare_queries(q))), rtol=1e-5,
                    atol=1e-6)


def test_cuda_sharded_forest_and_probe_launch_kernel5_a_shard(plain_forest_rescore):
    """4 shards on the card: the sharded forest and the sharded probe make one
    `rescore_topk` launch a shard a call, and answer as their plain chains."""
    from arroy_tpu_torch.ops import rescore as rs
    from arroy_tpu_torch.parallel.forest import ShardedForestIndex
    from arroy_tpu_torch.parallel.mesh import make_mesh

    require_cuda()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12_000, 48)).astype(np.float32)
    q = x[:32] + 0.3 * rng.standard_normal((32, 48)).astype(np.float32)
    idx = ShardedForestIndex.build(make_mesh(4), x, n_trees=3, seed=2)
    for call in (lambda: idx.search(q, 10, search_k=2000),
                 lambda: idx.probe_search(q, 10, search_k=2000, n_trees=3, block=16)):
        call()  # the probe packs its tables
        n0 = rs.launches["rescore_topk"]
        got = call()
        assert rs.launches["rescore_topk"] == n0 + 4
        tie_aware_equal(*got, *plain_forest_rescore(call), rtol=1e-5, atol=1e-6)


def test_cuda_forest_rescore_splits_past_2_31():
    """A list of B · c >= 2^31 candidates (c = 2,048, B = 2^20 + 1, rows of
    4) goes to the kernel in two launches (`rescore_topk` alone refuses
    it); sample queries of each launch equal the plain version."""
    from arroy_tpu_torch.ops import rescore as rs

    dev = require_cuda()
    b, c, cap = 2**20 + 1, 2048, 1 << 16
    s = _stage2_inputs(dev, "euclidean", b, cap, 4, live_share=1.0)
    cand = torch.empty((b, c), dtype=torch.int64, device=dev)
    cand.copy_(torch.arange(c, device=dev)[None, :].expand(b, c) * 31)
    cand.add_(torch.arange(b, device=dev)[:, None] * 13).remainder_(cap)
    valid = torch.ones((b, c), dtype=torch.bool, device=dev)
    valid[:, 5::7] = False
    common = (s["rows"], s["norms"], s["extras"], s["slot_to_id"], s["qv"], s["qn"], s["qe"])
    with pytest.raises(ValueError, match="2\\^31"):
        rs.rescore_topk(s["metric"], 4, 10, cand, valid, *common)
    n0 = rs.launches["rescore_topk"]
    ids, d = rs.forest_rescore(s["metric"], 4, 10, cand, valid, *common)
    torch.cuda.synchronize()
    assert rs.launches["rescore_topk"] == n0 + 2 and ids.shape == (b, 10)
    for i in (0, 1, rs.MAX_CANDIDATES // c - 1, rs.MAX_CANDIDATES // c, b - 1):
        sl = slice(i, i + 1)
        rids, rd = rs.rescore_topk_reference(
            s["metric"], 4, 10, cand[sl], valid[sl], s["rows"], s["norms"], s["extras"],
            s["slot_to_id"], s["qv"][sl], s["qn"][sl], s["qe"][sl])
        tie_aware_equal(ids[sl].cpu().numpy(), d[sl].cpu().numpy(), rids.cpu().numpy(),
                        rd.cpu().numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 6: the probe's stage 1 (`ops.rank_select`)
# ---------------------------------------------------------------------------

#: the f32 reordering tolerance of a centroid score: 1e-5 of its magnitude
#: (scale · Σ_d |q_d · c_d| + |caux|), as kernel 3's dots
RANK_RTOL = 1e-5


def _rank_inputs(dev, metric, b, T, nb_max, d, seed=0, valid_share=0.9):
    """(qcent, cent, caux, valid, scale) as the probe hands them to stage
    1: cosine unit centroids, euclidean ``2q·c − ‖c‖²``, the dot product
    raw, a binary metric's query decoded to ±1 against mean-of-±1
    centroids."""
    from arroy_tpu_torch.ops.binary import unpack_bits

    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((T * nb_max, d)).astype(np.float32)
    caux = np.zeros(T * nb_max, np.float32)
    scale = 2 if metric == "euclidean" else 1
    if metric == "cosine":
        cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    elif metric == "euclidean":
        caux = np.einsum("nd,nd->n", cent, cent).astype(np.float32)
    elif metric == "binary":
        cent = np.sign(cent).astype(np.float32) * rng.random((T * nb_max, 1)).astype(np.float32)
    valid = rng.random(T * nb_max) < valid_share
    valid[::nb_max] = True
    if metric == "binary":
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (b, -(-d // 32))).astype(np.int32))
        q = unpack_bits(words.to(dev), d).contiguous()
    else:
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    return (q, torch.from_numpy(cent).to(dev), torch.from_numpy(caux).to(dev),
            torch.from_numpy(valid).to(dev), scale)


def _check_rank(monkeypatch, q, cent, caux, valid, scale, L, nb_max):
    """Kernel 6 once (forced through `rank_blocks`' route, whatever the
    rule picks at the shape), against the plain chain: per (query, tree) L distinct
    blocks of the tree; every block whose float64 score is above the L-th
    by more than its tolerance is taken, every block taken is within its
    tolerance of the L-th or above, in descending order up to the
    tolerance; the plain chain's set differs only inside the tolerance.
    Returns the kernel's [B, T, L] block indices within their tree."""
    from arroy_tpu_torch.ops import rank_select as rs

    b, T = q.shape[0], cent.shape[0] // nb_max
    n0 = rs.launches["rank_select"]
    with monkeypatch.context() as m:
        m.setattr(rs, "uses_kernel", lambda *_a: True)
        got = rs.rank_blocks(q, cent, caux, valid, scale, L, nb_max)
    torch.cuda.synchronize()
    assert rs.launches["rank_select"] == n0 + 1
    want = rs.rank_blocks_reference(q, cent, caux, valid, scale, L, nb_max)
    assert got.shape == want.shape == (b, T * L) and got.dtype == torch.int64
    q64, c64 = q.double(), cent.double()
    s64 = scale * (q64 @ c64.T) - caux.double()[None, :]
    s64 = torch.where(valid[None, :], s64, -float("inf")).reshape(b, T, nb_max)
    tol = (RANK_RTOL * (scale * (q64.abs() @ c64.abs().T) + caux.double().abs()[None, :])
           ).reshape(b, T, nb_max)
    base = (torch.arange(T, device=q.device) * nb_max)[None, :, None]
    out = {}
    for name, ids in (("kernel", got), ("plain", want)):
        local = ids.reshape(b, T, L) - base
        assert bool(((local >= 0) & (local < nb_max)).all()), f"{name}: an id of another tree"
        taken = torch.zeros((b, T, nb_max), dtype=torch.bool, device=q.device)
        taken.scatter_(2, local, True)
        assert bool((taken.sum(2) == L).all()), f"{name}: a block twice"
        theta = torch.topk(s64, L, dim=2).values[..., -1:]
        sg, tg = s64.gather(2, local), tol.gather(2, local)
        assert not bool(((s64 > theta + tol) & ~taken).any()), f"{name}: a clear winner left out"
        assert bool((sg >= theta - tg).all()), f"{name}: a clear loser taken"
        out[name] = local
    sg, tg = s64.gather(2, out["kernel"]), tol.gather(2, out["kernel"])
    assert bool((sg[..., :-1] >= sg[..., 1:] - tg[..., :-1] - tg[..., 1:]).all()), "order"
    return out["kernel"]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot-product", "binary"])
@pytest.mark.parametrize("b", [1, 7, 256, 2048])
@pytest.mark.parametrize("L", [1, 25, 128])
@pytest.mark.parametrize("d", [100, 768])
def test_cuda_rank_select_matches_plain(monkeypatch, metric, b, L, d):
    """Three trees of 1,000 blocks (not a multiple of the 128-block tile),
    10% of them invalid."""
    dev = require_cuda()
    _check_rank(monkeypatch, *_rank_inputs(dev, metric, b, 3, 1000, d, seed=b + L), L, 1000)


@pytest.mark.parametrize("L", [25, 128])
@pytest.mark.parametrize("b", [7, 256])
def test_cuda_rank_select_fewer_valid_than_L(monkeypatch, b, L):
    """Tree 0 has 10 valid blocks: all of them, then its invalid blocks
    from the lowest; tree 1 is all valid but its first block."""
    dev = require_cuda()
    q, cent, caux, valid, scale = _rank_inputs(dev, "euclidean", b, 2, 900, 100, seed=3)
    valid[:900] = False
    valid[torch.arange(0, 900, 90, device=dev)] = True
    valid[900:] = True
    valid[900] = False
    local = _check_rank(monkeypatch, q, cent, caux, valid, scale, L, 900)
    head = torch.sort(local[:, 0, :10], dim=1).values
    assert torch.equal(head, torch.arange(0, 900, 90, device=dev)[None, :].expand(b, 10))
    rest = [j for j in range(900) if j % 90][: L - 10]
    assert torch.equal(local[:, 0, 10:], torch.tensor(rest, device=dev)[None, :].expand(b, -1))


@pytest.mark.parametrize("L", [1, 25, 128])
@pytest.mark.parametrize("b", [1, 256])
def test_cuda_rank_select_exact_ties(monkeypatch, b, L):
    """Centroids that repeat 5 distinct rows: equal scores, exactly, in
    any summation order; the kernel takes them by descending score, equal
    scores by the lower block, on every tile and column range."""
    dev = require_cuda()
    q, _, _, valid, scale = _rank_inputs(dev, "dot-product", b, 2, 700, 100, seed=5)
    rows = torch.from_numpy(np.random.default_rng(6).standard_normal((5, 100)).astype(np.float32))
    pick = torch.tensor([(j * 7919) % 5 for j in range(1400)])
    cent = rows[pick].to(dev).contiguous()
    caux = torch.zeros(1400, device=dev)
    valid[:] = True
    local = _check_rank(monkeypatch, q, cent, caux, valid, scale, L, 700)
    s = (q.double() @ rows.to(dev).double().T)  # [B, 5]
    for t in range(2):
        group = pick[t * 700:(t + 1) * 700].to(dev)
        key = s[:, group]  # [B, 700]
        order = torch.sort(-key, dim=1, stable=True).indices[:, :L]
        assert torch.equal(local[:, t], order), t


@pytest.mark.parametrize("b,T,nb_max,sms,per_sm,want", [
    (2048, 8, 23_100, 132, 1, 1),   # the probe cell: 128 CTAs on 132 SMs
    (2048, 8, 23_100, 132, 2, 2),   # two CTAs an SM: 256 of 264 slots
    (256, 8, 23_100, 132, 1, 8),    # 16 (query tile, tree) pairs, 8 ranges each
    (256, 4, 8_192, 132, 1, 16),    # 64 tiles: 16 ranges of 4 (15 would leave 2 empty)
    (7, 8, 23_100, 132, 1, 16),     # 181 tiles: 15 ranges of 13 would be 14
    (1, 1, 23_100, 132, 1, 31),     # the most ranges none of which is empty
    (1, 1, 300, 132, 1, 3),         # no more ranges than the tree has tiles
    (4096, 10, 5_000, 132, 1, 2),   # 320 CTAs fill their 3 waves 0.81; 640 fill 5 0.97
])
def test_cuda_rank_select_plan_fills_the_card(b, T, nb_max, sms, per_sm, want):
    """Kernel 6's column ranges (`rank_select_plan` in the library): the
    fewest, none of them empty, whose CTAs fill 90% of their last wave."""
    import ctypes

    from arroy_tpu_torch.ops import rank_select as rs

    require_cuda()
    lib = rs._lib()
    lib.rank_select_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    got = ctypes.c_int(0)
    assert lib.rank_select_plan(b, T, nb_max, sms, per_sm, ctypes.byref(got)) == 0
    assert got.value == want


def _probe_cell_index(dev, m=100_000, d=32, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    db = Database(None, device=dev)
    w = Writer(db, 0, d, metric="cosine")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m), x)
        w.builder(seed=seed).n_trees(8).build(wtxn)
    return Reader.open(db.read(), 0, db, metric="cosine"), x


def _searcher_at_L(r, L, **kw):
    """A probe searcher over 8 trees of 64-slot blocks whose L (blocks a
    tree) is `L`: search_k = L · T · P · fill."""
    kw = dict(engine="forest", traversal="probe", probe_trees=8, probe_block=64, **kw)
    fill = r.searcher(10, search_k=1000, **kw).device_fn.tables.fill
    s = r.searcher(10, search_k=L * int(8 * 64 * fill), **kw)
    assert s.route == "probe" and s.device_fn.L == L
    return s


def test_cuda_probe_launches_kernel6_once_a_batch(monkeypatch):
    """The probe at the cell's geometry (T = 8, P = 64, L = 25) over
    tables the route rule sends to the kernel from `min_queries` queries:
    one launch of kernel 6 a batch, no plain call, the answers tie-aware
    equal to the plain chain's on the card; L past `MAX_L`, or one query
    fewer, take the plain chain, once a batch, counted."""
    from arroy_tpu_torch.ops import rank_select as rs

    dev = require_cuda()
    r, x = _probe_cell_index(dev)
    s = _searcher_at_L(r, 25)
    least = rs.min_queries(s.device_fn.tables.cent.shape[0], 32, 25)
    assert least is not None
    q = x[:least] + 0.05 * np.random.default_rng(2).standard_normal((least, 32)).astype(np.float32)
    dq = s.prepare_queries(q)
    n0, p0 = rs.launches["rank_select"], rs.plain_calls["rank_blocks"]
    got = [_result_arrays(s.device_fn(*dq)) for _ in range(3)]
    assert rs.launches["rank_select"] == n0 + 3 and rs.plain_calls["rank_blocks"] == p0
    with monkeypatch.context() as m:
        m.setattr(rs, "MAX_L", 0)
        want = _result_arrays(s.device_fn(*dq))
    assert rs.launches["rank_select"] == n0 + 3 and rs.plain_calls["rank_blocks"] == p0 + 1
    for g in got:
        tie_aware_equal(*g, *want, rtol=1e-5, atol=1e-6)
    big = _searcher_at_L(r, rs.MAX_L + 8)
    n0, p0 = rs.launches["rank_select"], rs.plain_calls["rank_blocks"]
    big.device_fn(*big.prepare_queries(q))
    big.device_fn(*big.prepare_queries(q))
    s.device_fn(*s.prepare_queries(q[: least - 1]))
    assert rs.launches["rank_select"] == n0 and rs.plain_calls["rank_blocks"] == p0 + 3
    s.device_fn(*s.prepare_queries(q))
    assert rs.launches["rank_select"] == n0 + 1


def test_cuda_sharded_probe_launches_kernel6_a_shard(monkeypatch):
    """4 shards on the card, stage 1 on kernel 6 (forced: the shards'
    tables are smaller than the route rule's): the sharded probe launches
    it once a shard a call and answers as with the plain chain."""
    from arroy_tpu_torch.ops import rank_select as rs
    from arroy_tpu_torch.parallel.forest import ShardedForestIndex
    from arroy_tpu_torch.parallel.mesh import make_mesh

    require_cuda()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((12_000, 48)).astype(np.float32)
    q = x[:48] + 0.3 * rng.standard_normal((48, 48)).astype(np.float32)
    idx = ShardedForestIndex.build(make_mesh(4), x, n_trees=3, seed=2)

    def call():
        return idx.probe_search(q, 10, search_k=2000, n_trees=3, block=16)

    call()  # the probe packs its tables
    n0, p0 = rs.launches["rank_select"], rs.plain_calls["rank_blocks"]
    with monkeypatch.context() as m:
        m.setattr(rs, "uses_kernel", lambda *_a: True)
        got = call()
    assert rs.launches["rank_select"] == n0 + 4 and rs.plain_calls["rank_blocks"] == p0
    want = call()
    assert rs.launches["rank_select"] == n0 + 4 and rs.plain_calls["rank_blocks"] == p0 + 4
    tie_aware_equal(*got, *want, rtol=1e-5, atol=1e-6)
