"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; JAX runs
its Pallas kernels in interpret mode and through their jnp oracles, as
`tests/test_pallas_exact.py` and `tests/test_pallas.py` do.

Fused select tolerance (that of `tests/test_pallas_exact.py`): packed
keys within 2·bm (one value quantum plus the lane bits; separately
compiled f32 expressions may round a score 1 ulp apart), >= 98% of keys
equal, indices equal wherever keys are.  Hamming: bit-exact.

The CUDA kernels themselves are held against these plain versions in
`tests/test_torch_cuda.py`, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arroy_tpu.ops.pallas_exact import (
    DEAD_KEY_MAX as J_DEAD_KEY_MAX,
    fused_block_select as j_select,
    fused_block_select_reference as j_select_ref,
)
from arroy_tpu.ops.pallas_kernels import bq_hamming_matrix as j_hamming
from arroy_tpu_torch.ops import bq_kernels, fused_select
from arroy_tpu_torch.ops.fused_select import DEAD_KEY_MAX, fused_block_select

from .torch_util import to_torch


def _mk(b=8, m=4096, d=128, dtype="int8", seed=0):
    """Seeded inputs as (numpy for JAX, tensors for the port)."""
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((b, d)).astype(np.float32)
    xf = rng.standard_normal((m, d)).astype(np.float32)
    qsc = rng.random(b).astype(np.float32) + 0.5
    mult = rng.random(m).astype(np.float32) + 0.5
    add = rng.standard_normal(m).astype(np.float32)
    if dtype == "int8":
        q = np.clip(np.round(qf * 20), -127, 127).astype(np.int8)
        x = np.clip(np.round(xf * 20), -127, 127).astype(np.int8)
        jq, jx = jnp.asarray(q), jnp.asarray(x)
        tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    else:  # both frameworks round f32 -> bf16 to nearest even
        jq, jx = jnp.asarray(qf, jnp.bfloat16), jnp.asarray(xf, jnp.bfloat16)
        tq, tx = torch.from_numpy(qf).to(torch.bfloat16), torch.from_numpy(xf).to(torch.bfloat16)
    jax_in = (jq, jx, jnp.asarray(qsc), jnp.asarray(mult), jnp.asarray(add))
    torch_in = (tq, tx, torch.from_numpy(qsc), torch.from_numpy(mult), torch.from_numpy(add))
    return jax_in, torch_in


def _assert_keys_close(keys, idx, rkeys, ridx, bm):
    keys, rkeys = np.asarray(keys, np.int64), np.asarray(rkeys, np.int64)
    exact = keys == rkeys
    assert np.abs(keys - rkeys).max() <= 2 * bm, "keys differ beyond one quantum"
    assert exact.mean() >= 0.98
    np.testing.assert_array_equal(np.asarray(idx)[exact], np.asarray(ridx)[exact])


def test_dead_key_constant():
    assert DEAD_KEY_MAX == J_DEAD_KEY_MAX


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("bm", [256, 1024])
@pytest.mark.parametrize("oracle", ["interpret", "reference"])
def test_plain_select_matches_jax(dtype, bm, oracle):
    jax_in, torch_in = _mk(dtype=dtype)
    if oracle == "interpret":
        rkeys, ridx = j_select(*jax_in, bm=bm, interpret=True)
    else:
        rkeys, ridx = j_select_ref(*jax_in, bm=bm)
    keys, idx = fused_block_select(*torch_in, bm=bm)  # CPU → plain version
    assert keys.dtype == idx.dtype == torch.int32
    assert keys.shape == (8, 2 * (4096 // bm))
    _assert_keys_close(keys.numpy(), idx.numpy(), rkeys, ridx, bm)
    if dtype == "int8":  # exact int dots + the same unfused affine: bit-equal
        np.testing.assert_array_equal(keys.numpy(), np.asarray(j_select_ref(*jax_in, bm=bm)[0]))


def test_plain_select_dead_slots_never_win():
    jax_in, (q, x, qsc, mult, add) = _mk(m=2048)
    add = add.clone()
    add[100:1100] = float("-inf")  # kill most of blocks 0/1
    keys, idx = fused_block_select(q, x, qsc, mult, add, bm=1024)
    dead = (idx >= 100) & (idx < 1100)
    assert not bool((dead & (keys > DEAD_KEY_MAX)).any()), "dead slot won a block"
    # every key of an all-dead block sits at or below DEAD_KEY_MAX
    add[:] = float("-inf")
    keys, _ = fused_block_select(q, x, qsc, mult, add, bm=1024)
    assert bool((keys <= DEAD_KEY_MAX).all())


def test_plain_select_odd_query_count():
    jax_in, torch_in = _mk(b=5, m=2048)
    rkeys, ridx = j_select(*jax_in, bm=1024, interpret=True)
    keys, idx = fused_block_select(*torch_in, bm=1024)
    assert keys.shape == (5, 4) and idx.shape == (5, 4)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rkeys))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))


@pytest.mark.parametrize("b,m,w", [(1, 1, 2), (7, 130, 4), (130, 1537, 24)])
def test_plain_hamming_matches_jax(b, m, w):
    rng = np.random.default_rng(b * 1000 + m)
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (m, w), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(j_hamming(jnp.asarray(q), jnp.asarray(x), interpret=True))
    got = bq_kernels.bq_hamming_matrix(to_torch(q), to_torch(x))  # CPU → plain
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_count_only_launches_on_the_card():
    before = (dict(fused_select.launches), dict(bq_kernels.launches))
    _, torch_in = _mk(b=2, m=256)
    fused_block_select(*torch_in)
    bq_kernels.bq_hamming_matrix(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((3, 2), dtype=torch.int32))
    assert (fused_select.launches, bq_kernels.launches) == before
