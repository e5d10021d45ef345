"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every case is marked `gpu` and skips where there is no CUDA
device.  The file imports no JAX, so it also runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest -p no:cacheprovider

Tolerances: int8 select keys/indices and hamming counts bit-equal; bf16
select keys within 2·bm with >= 98% equal and indices equal where keys
are (that of `tests/test_pallas_exact.py`).
"""

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch.ops import bq_kernels, fused_select
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


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("b,m,bm", [(130, 8192, 256), (5, 4096, 1024), (64, 2048, 256)])
def test_cuda_select_matches_plain(dtype, b, m, bm):
    dev = require_cuda()
    inputs = _select_inputs(dev, b, m, 256, dtype)
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


@pytest.mark.parametrize("b,m,w", [(1, 1, 2), (130, 1537, 24), (9, 700, 33)])
def test_cuda_hamming_matches_plain(b, m, w):
    dev = require_cuda()
    rng = np.random.default_rng(b + m + w)
    q = to_torch(rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32), dev)
    x = to_torch(rng.integers(0, 2**32, (m, w), dtype=np.uint64).astype(np.uint32), dev)
    n0 = bq_kernels.launches["bq_hamming"]
    got = bq_kernels.bq_hamming_matrix(q, x)
    assert bq_kernels.launches["bq_hamming"] == n0 + 1
    assert torch.equal(got, bq_kernels.bq_hamming_matrix_reference(q, x))


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
