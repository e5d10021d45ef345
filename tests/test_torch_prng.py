"""`arroy_tpu_torch.prng` against `jax.random` and `jax._src.prng`.

Every primitive must give the JAX package's words bit for bit, on keys
drawn by hypothesis from seeds and fold-in data: the threefry block,
keys from seeds, fold_in, split, random bits, randint (shapes () and
(10,), spans 1, 2, and near and past 2**16), uniform and bernoulli, also
read at lane offsets past 2**17 as the routing coins are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax._src import prng as jprng

from arroy_tpu_torch import prng

from . import torch_util  # noqa: F401  (single-threaded torch)

seeds = st.integers(min_value=0, max_value=2**32 - 1)
words = st.integers(min_value=0, max_value=2**32 - 1)
SETTINGS = settings(max_examples=25, deadline=None)


def _jkey(seed, data):
    return jax.random.fold_in(jax.random.key(seed), data)


def _tkey(seed, data):
    return prng.as_tensor(prng.fold_in(prng.key(seed), data), "cpu")


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


@SETTINGS
@given(seed=seeds)
def test_key_from_seed(seed):
    np.testing.assert_array_equal(prng.key(seed), _kd(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.key(seed), np.asarray(jprng.threefry_seed(jnp.uint32(seed))))


@SETTINGS
@given(k0=words, k1=words, n=st.integers(min_value=1, max_value=300))
def test_threefry_block(k0, k1, n):
    """The block itself, on 2n counters, against `jax._src.prng.threefry_2x32`."""
    counts = np.random.default_rng(k0 ^ k1).integers(0, 2**32, 2 * n, dtype=np.uint64)
    want = np.asarray(
        jprng.threefry_2x32(jnp.asarray([k0, k1], jnp.uint32), jnp.asarray(counts, jnp.uint32))
    )
    c = torch.from_numpy(counts.astype(np.int64))
    y0, y1 = prng.threefry2x32(torch.tensor(k0), torch.tensor(k1), c[:n], c[n:])
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy().astype(np.uint32), want)


@SETTINGS
@given(seed=seeds, data=words, more=words)
def test_fold_in_and_split(seed, data, more):
    jk = _jkey(seed, data)
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data), _kd(jk))
    # host and device keys agree; a device batch folds each its own datum
    tk = _tkey(seed, data)
    np.testing.assert_array_equal(
        prng.key_data(prng.fold_in(tk, more)), _kd(jax.random.fold_in(jk, more))
    )
    batch = prng.fold_in(tk[None, :].expand(3, 2), torch.tensor([0, more, 7]))
    for i, d in enumerate((0, more, 7)):
        np.testing.assert_array_equal(prng.key_data(batch[i]), _kd(jax.random.fold_in(jk, d)))
    for num in (2, 3):
        want = _kd(jax.random.split(jk, num))
        np.testing.assert_array_equal(prng.key_data(prng.split(tk, num)), want)
        np.testing.assert_array_equal(prng.split(prng.fold_in(prng.key(seed), data), num), want)


@SETTINGS
@given(seed=seeds, data=words, shape=st.sampled_from([(), (1,), (10,), (3, 5), (257,)]))
def test_random_bits(seed, data, shape):
    want = np.asarray(jax.random.bits(_jkey(seed, data), shape, jnp.uint32))
    got = prng.random_bits(_tkey(seed, data), shape).numpy().astype(np.uint32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(
    seed=seeds,
    data=words,
    span=st.sampled_from(
        [1, 2, 3, 12, 1000, 2**16 - 1, 2**16, 2**16 + 1, 70_001, 2**20 + 7, 2**31 - 1]
    ),
    lo=st.sampled_from([0, -5, 2**20]),
    shape=st.sampled_from([(), (10,)]),
)
def test_randint(seed, data, span, lo, shape):
    hi = min(lo + span, 2**31 - 1)
    want = np.asarray(jax.random.randint(_jkey(seed, data), shape, lo, hi))
    got = prng.randint(_tkey(seed, data), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(seed=seeds, data=words)
def test_randint_batched_spans(seed, data):
    """The two-means draws: one key per (segment, attempt), each with its
    own span, as `jax.vmap` of randint gives them; an empty span (max <=
    min) returns min."""
    spans = np.array([[2], [17], [2**16 + 3], [0]], np.int64)
    keys = prng.fold_in(_tkey(seed, data)[None, None, :], torch.arange(3)[None, :])  # [1, 3, 2]
    keys = keys.expand(4, 3, 2)
    got = prng.randint(keys, (10,), 0, torch.from_numpy(spans)).numpy()
    jk = _jkey(seed, data)
    for s in range(4):
        for a in range(3):
            jka = jax.random.fold_in(jk, a)
            want = np.asarray(jax.random.randint(jka, (10,), 0, int(spans[s, 0])))
            np.testing.assert_array_equal(got[s, a], want)


@SETTINGS
@given(seed=seeds, data=words, n=st.integers(min_value=1, max_value=600))
def test_uniform(seed, data, n):
    want = np.asarray(jax.random.uniform(_jkey(seed, data), (n,)))
    got = prng.uniform(_tkey(seed, data), (n,)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want = np.asarray(jax.random.uniform(_jkey(seed, data), (n,), minval=-2.0, maxval=3.0))
    got = prng.uniform(_tkey(seed, data), (n,), -2.0, 3.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@SETTINGS
@given(seed=seeds, data=words, p=st.sampled_from([0.5, 0.1, 0.99]))
def test_bernoulli(seed, data, p):
    want = np.asarray(jax.random.bernoulli(_jkey(seed, data), p, (1000,)))
    np.testing.assert_array_equal(prng.bernoulli(_tkey(seed, data), p, (1000,)).numpy(), want)


@pytest.mark.parametrize("n", [(1 << 17) + 300, (1 << 18) + 5])
def test_bernoulli_at_lanes_past_2_17(n):
    """A coin read at chosen lanes equals that lane of the whole draw: the
    routing coins of a lane past 2**17, and the fallback coins of a lane
    deep in a frame."""
    jk = _jkey(11, 0x5EED)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, (n,)))
    lanes = torch.tensor([0, 1, (1 << 17) - 1, 1 << 17, n - 1] + list(range(n - 200, n - 1, 7)))
    got = prng.bernoulli_at(_tkey(11, 0x5EED), lanes).numpy()
    np.testing.assert_array_equal(got, want[lanes.numpy()])
    # per-lane keys, as the grow's fallback draws them
    keys = _tkey(11, 0x5EED)[None, :].expand(len(lanes), 2)
    np.testing.assert_array_equal(prng.bernoulli_at(keys, lanes).numpy(), want[lanes.numpy()])


def test_the_builds_key_chain():
    """The writer's derivations, host side: inserts at 0x0F0F + off, grows
    at 0xB111D, later grow groups at 0x6B0 + gi, the budget mode's node
    and attempt keys and its numpy generator's seed words."""
    k, jk = prng.key(64), jax.random.key(64)
    g, jg = prng.fold_in(k, 0xB111D), jax.random.fold_in(jk, 0xB111D)
    np.testing.assert_array_equal(g, _kd(jg))
    for key, jkey, data in ((k, jk, 0x0F0F + 28), (g, jg, 0x6B0 + 3)):
        np.testing.assert_array_equal(prng.fold_in(key, data), _kd(jax.random.fold_in(jkey, data)))
    np.testing.assert_array_equal(
        prng.fold_in(prng.fold_in(g, 5), 2), _kd(jax.random.fold_in(jax.random.fold_in(jg, 5), 2))
    )
    a = np.random.default_rng(prng.key_data(g)).integers(0, 1 << 30, 8)
    b = np.random.default_rng(np.asarray(jax.random.key_data(jg)).ravel()).integers(0, 1 << 30, 8)
    np.testing.assert_array_equal(a, b)
