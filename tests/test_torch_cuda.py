"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every case is marked `gpu` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest -p no:cacheprovider

Tolerances: int8 select keys/indices and hamming counts bit-equal; bf16
select keys within 2·bm with >= 98% equal and indices equal where keys
are (that of `tests/test_pallas_exact.py`); gather-score within
1e-5 · Σ_d |row·q| of the plain version (the same operands, summed in
another order).
"""

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
