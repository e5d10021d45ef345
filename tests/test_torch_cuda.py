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


def _gather_inputs(dev, nbt, p, d, b, c, dtype, seed=0):
    """Rows [nbt, p, d] of `dtype`, ids [b, c] with repeats and the last
    block, f32 queries [b, d]."""
    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.standard_normal((nbt, p, d)).astype(np.float32))
    rows = {"f32": xf, "bf16": xf.to(torch.bfloat16),
            "int8": torch.clamp(torch.round(xf * 40), -127, 127).to(torch.int8)}[dtype]
    bid = rng.integers(nbt, size=(b, c)).astype(np.int32)
    if b and c:
        bid[0, :] = bid[0, 0]  # one query repeats one block
        bid[-1, -1] = nbt - 1  # the last block
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
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
