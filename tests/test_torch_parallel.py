"""The port's mesh layer (`arroy_tpu_torch.parallel.mesh`) against the
JAX package's, on an 8-shard CPU mesh beside its 8-device virtual mesh.

`tests/test_parallel.py`'s five tests on the port, then parity: the
same inputs (numpy, from a seed) through both packages.

Tolerances:
- the hash `_mix` and the integer left counts: bit-equal;
- searches: ids equal tie-aware, distances rtol 1e-5 with a 1e-6
  absolute floor (f32 sums in another order), NaN where the JAX
  package's are NaN;
- margins: rtol 1e-5 with a 1e-6 absolute floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from arroy_tpu.metrics import Euclidean as JEuclidean
from arroy_tpu.parallel import build as j_build
from arroy_tpu.parallel import mesh as j_mesh
from arroy_tpu_torch.metrics import Euclidean
from arroy_tpu_torch.parallel import build as t_build
from arroy_tpu_torch.parallel.mesh import AXIS, ShardedExactIndex, make_mesh, sharded_margin_step

from .torch_util import tie_aware_equal
from .util import random_vectors


def test_mesh_has_8_devices():
    mesh = make_mesh(8, device="cpu")
    assert mesh.devices.size == 8 and AXIS == j_mesh.AXIS
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(device="cpu").devices.size == 1


def test_make_mesh_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh would be made")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


def test_sharded_exact_matches_single_device():
    x = random_vectors(257, 16, seed=1)  # deliberately not divisible by 8
    idx = ShardedExactIndex(make_mesh(8, device="cpu"), x, metric="euclidean")
    q = x[:5]
    ids, dists = idx.search(q, 10)
    d = np.sum((x[None, :, :] - q[:, None, :]) ** 2, axis=-1)
    want = np.argsort(d, axis=1)[:, :10]
    for b in range(5):
        assert set(ids[b]) == set(want[b])
        np.testing.assert_allclose(np.sort(dists[b]), np.sort(np.sqrt(d[b][want[b]])), rtol=1e-4)


def test_sharded_exact_cosine():
    x = random_vectors(64, 8, seed=2)
    idx = ShardedExactIndex(make_mesh(8, device="cpu"), x, metric="cosine")
    ids, dists = idx.search(x[:3], 5)
    assert ids[0][0] == 0 and abs(dists[0][0]) < 1e-5


def test_sharded_margin_step_matches_local():
    mesh = make_mesh(8, device="cpu")
    m, d, g = 64, 16, 4
    x = random_vectors(m, d, seed=3)
    seg = np.repeat(np.arange(g, dtype=np.int32), m // g)
    normals = random_vectors(g, d, seed=4)
    aux = np.zeros(g, np.float32)
    margins, left = sharded_margin_step(mesh, Euclidean, g, x, np.zeros(m, np.float32), seg,
                                        normals, aux)
    want_m = np.sum(x * normals[seg], axis=1)
    np.testing.assert_allclose(margins.numpy(), want_m, rtol=1e-5)
    want_left = np.asarray([np.sum(np.signbit(want_m[seg == i])) for i in range(g)], np.int32)
    np.testing.assert_array_equal(left.numpy(), want_left)


def test_sharded_exact_pads_with_nan_not_id_zero():
    """Shards holding only padding rows contribute (id 0, +inf) entries;
    they must surface as NaN, like every single-device path."""
    x = np.asarray(np.random.default_rng(3).standard_normal((10, 16)), np.float32)
    idx = ShardedExactIndex(make_mesh(8, device="cpu"), x, metric="euclidean")
    ids, dists = idx.search(x[:4], 16)
    for row_i, row_d in zip(ids, dists):
        valid = ~np.isnan(row_d)
        assert valid.sum() == 10  # exactly the live items
        assert sorted(row_i[valid]) == sorted(set(row_i[valid]))


# ---------------------------------------------------------------------------
# parity with the JAX package on its 8-device virtual mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric,with_filter", [
    ("euclidean", False), ("euclidean", True), ("cosine", False), ("dot-product", False),
    ("manhattan", False), ("binary quantized cosine", False),
])
def test_sharded_exact_matches_jax(metric, with_filter):
    x = random_vectors(301, 16, seed=6)
    q = random_vectors(12, 16, seed=7)
    ids = np.random.default_rng(8).permutation(10_000)[:301].astype(np.uint32)
    cand = ids[np.random.default_rng(9).choice(301, 120, replace=False)] if with_filter else None
    jidx = j_mesh.ShardedExactIndex(j_mesh.make_mesh(8), x, metric=metric, ids=ids)
    tidx = ShardedExactIndex(make_mesh(8, device="cpu"), x, metric=metric, ids=ids)
    jids, jd = jidx.search(q, 10, candidates=cand)
    tids, td = tidx.search(q, 10, candidates=cand)
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    tie_aware_equal(tids, np.nan_to_num(td), jids.astype(np.int64), np.nan_to_num(jd),
                    rtol=1e-5, atol=1e-6)
    if cand is not None:
        assert set(tids[~np.isnan(td)].tolist()) <= set(cand.tolist())


def test_sharded_margin_step_matches_jax():
    jm = j_mesh.make_mesh(8)
    m, d, g = 96, 16, 5
    x = random_vectors(m, d, seed=10)
    seg = np.random.default_rng(11).integers(g, size=m).astype(np.int32)
    normals = random_vectors(g, d, seed=12)
    aux = random_vectors(g, 1, seed=13)[:, 0]
    ex = np.zeros(m, np.float32)
    put = lambda a, *spec: jax.device_put(a, NamedSharding(jm, P(*spec)))  # noqa: E731
    want_m, want_l = j_mesh.sharded_margin_step(
        jm, JEuclidean, g, put(x, j_mesh.AXIS, None), put(ex, j_mesh.AXIS),
        put(seg, j_mesh.AXIS), put(normals, None, None), put(aux, None))
    got_m, got_l = sharded_margin_step(make_mesh(8, device="cpu"), Euclidean, g, x, ex, seg,
                                       normals, aux)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_mix_matches_jax():
    """`_mix` on 2^20 random words and the edges, `_mix_host`, the seed
    salt and the positive draw ``(h >> 1) | 1``: bit-equal."""
    words = np.random.default_rng(14).integers(0, 1 << 32, size=1 << 20, dtype=np.uint64)
    words[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    got = t_build._mix(torch.from_numpy(words.astype(np.int64))).numpy()
    want = np.asarray(jax.jit(j_build._mix)(jnp.asarray(words.astype(np.uint32))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for i, w in enumerate(words[:64].tolist()):
        assert t_build._mix_host(w) == j_build._mix_host(w) == int(want[i])
    # the per-entry hash base of a shard whose slots start at 2**32 - 40
    m_l, off = 64, (1 << 32) - 40
    sh = t_build._Shard(np.zeros((m_l, 2), np.float32), np.zeros(m_l, np.float32),
                        np.zeros(m_l, np.float32), np.zeros((16, m_l), np.int64), off, 16, "cpu")
    want_gid = (np.arange(16, dtype=np.uint32)[:, None] * np.uint32(0x9E3779B9)
                + (off + np.arange(m_l)).astype(np.uint32)[None, :])
    np.testing.assert_array_equal(sh.gid.numpy(), want_gid.astype(np.int64))
    draw = ((torch.from_numpy(got) >> 1) | 1).numpy()
    want_draw = np.asarray((jnp.asarray(want) >> 1).astype(jnp.int32) | 1)
    np.testing.assert_array_equal(draw, want_draw.astype(np.int64))
