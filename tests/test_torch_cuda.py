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


@pytest.mark.parametrize("filtered", [False, True])
def test_cuda_traversal_syncs_once_a_block(tmp_path, filtered):
    """The pop loop reads the batch's "any query active" flag once every
    POP_BLOCK pops and synchronizes nowhere else (PyTorch's sync debug
    mode warns on every synchronizing call)."""
    from arroy_tpu_torch.search import POP_BLOCK

    gr, _, q = _traversal_pair(tmp_path)
    cand = np.arange(0, 6000, 2) if filtered else None  # 3,000 ids: more than search_k
    s = gr.searcher(10, search_k=2000, engine="forest", traversal="xla", candidates=cand)
    assert s.route == "traversal"
    fn = s.device_fn
    dq = s.prepare_queries(q)
    m = fn.margins(dq[0], dq[3])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, pops, _ = fn.traverse(m, fn.pmax, fn.q_cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(w.filename, w.lineno) for w in rec
             if str(w.message).startswith("called a synchronizing CUDA operation")]
    assert len(syncs) == -(-int(pops.max()) // POP_BLOCK), syncs
    assert len(set(syncs)) == 1, syncs  # all of them the block's one read


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
    cuBLAS and recall >= 0.99 of the CPU's ids."""
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
    devices sum in other orders), which must be few, or a split without a
    normal (a coin from each device's own generator); both are counted."""
    from arroy_tpu_torch import builder
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
            gen = torch.Generator(device=device).manual_seed(0)
            out = builder.route_items(ctx, ctx.staging_matrix_dev(), ctx.staging_aux_np(),
                                      [(r, slots) for r in f.roots], gen)
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
    # walk each differing lane's CPU path in every tree: it must meet a coin
    # or a split whose |margin| is within 1e-5 of the sum of its terms'
    # magnitudes (binary metrics: exact integer sums, so only coins)
    rows, _, extras = st.store.device_arrays("cpu")
    normals = torch.from_numpy(f.normals.view(np.int32) if st.metric.binary else f.normals)
    why = {"coin": 0, "near": 0, "none": 0}
    for s_ in differ:
        seen = set()
        for root in f.roots:
            nid = root
            while f.kind[nid] != KIND_LEAF:
                if f.kind[nid] == KIND_SPLIT_NONE:
                    seen.add("coin")
                    break
                n, a_ = normals[f.ptr[nid]], float(f.aux[f.ptr[nid]])
                v = rows[s_]
                qf = float(extras[s_]) if st.metric.has_extra else 1.0
                m = float(st.metric.margin(n, torch.tensor(a_), v, qf))
                if not st.metric.binary:
                    if abs(m) <= 1e-5 * (float((n.abs() * v.abs()).sum()) + abs(a_ * qf)):
                        seen.add("near")
                nid = int(f.left[nid]) if np.signbit(m) else int(f.right[nid])
        why["coin" if "coin" in seen else "near" if "near" in seen else "none"] += 1
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
    CUDA function by name, in the profiler's tables and in the trace file."""
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
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        assert "fused_select_kernel" in f.read()


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
