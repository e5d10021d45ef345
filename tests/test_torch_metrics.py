"""The port's metrics and bit codec (`arroy_tpu_torch.metrics`,
`arroy_tpu_torch.ops.binary`) against the JAX package on the same
seeded inputs, zero vectors included.

Float results: rtol 1e-5, atol 1e-6 (f32 sums taken in another order).
Packed words, popcounts and ±1 decodes: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arroy_tpu import metrics as jm
from arroy_tpu.ops import binary as jb
from arroy_tpu_torch import metrics as tm
from arroy_tpu_torch.ops import binary as tb

from .torch_util import to_torch

RTOL, ATOL = 1e-5, 1e-6
METRICS = [m.name for m in jm.ALL_METRICS]
D = 40  # not a multiple of 32 or 64: exercises BQ padding bits


def _pair(name):
    return jm.metric_by_name(name), tm.metric_by_name(name)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _vectors(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0  # zero vector
    x[1, ::3] = -0.0  # signed zeros
    return x


def _rows(metric, x):
    rows = metric.encode_np(x)
    return rows, metric.item_norms_np(rows, x.shape[1])


@pytest.mark.parametrize("name", METRICS)
def test_built_and_normalized_distance(name):
    jmet, tmet = _pair(name)
    rng = np.random.default_rng(1)
    x = _vectors(rng, 50)
    q = _vectors(rng, 6)
    rows, norms = _rows(jmet, x)
    qv, qn = _rows(jmet, q)
    extras = rng.random(50).astype(np.float32)
    qe = np.zeros(6, np.float32)
    jd = jmet.built_distance(
        jnp.asarray(qv)[:, None, :], jnp.asarray(qn)[:, None], jnp.asarray(qe)[:, None],
        jnp.asarray(rows)[None], jnp.asarray(norms)[None], jnp.asarray(extras)[None],
    )
    td = tmet.built_distance(
        to_torch(qv)[:, None, :], to_torch(qn)[:, None], to_torch(qe)[:, None],
        to_torch(rows)[None], to_torch(norms)[None], to_torch(extras)[None],
    )
    _close(td, jd)
    _close(tmet.normalized_distance(td, D), jmet.normalized_distance(jd, D))


@pytest.mark.parametrize("name", METRICS)
def test_margin_matrix(name):
    jmet, tmet = _pair(name)
    rng = np.random.default_rng(2)
    normals, _ = _rows(jmet, _vectors(rng, 30))
    aux = rng.standard_normal(30).astype(np.float32)
    qv, _ = _rows(jmet, _vectors(rng, 7))
    qf = rng.random(7).astype(np.float32)
    jmm = jmet.margin_matrix(jnp.asarray(normals), jnp.asarray(aux), jnp.asarray(qv), jnp.asarray(qf))
    tmm = tmet.margin_matrix(to_torch(normals), to_torch(aux), to_torch(qv), to_torch(qf))
    _close(tmm, jmm)
    # the per-row margin used by the builder
    jmr = jmet.margin(jnp.asarray(normals[:7]), jnp.asarray(aux[:7]), jnp.asarray(qv), jnp.asarray(qf))
    tmr = tmet.margin(to_torch(normals[:7]), to_torch(aux[:7]), to_torch(qv), to_torch(qf))
    _close(tmr, jmr)


@pytest.mark.parametrize("name", METRICS)
def test_two_means_pieces_and_finalize_split(name):
    jmet, tmet = _pair(name)
    rng = np.random.default_rng(3)
    rows, norms = _rows(jmet, _vectors(rng, 12))
    jt = jmet.tm_decode(jnp.asarray(rows), D)
    tt = tmet.tm_decode(to_torch(rows), D)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))  # codec: exact
    tv = np.asarray(jt)
    e = rng.random(12).astype(np.float32)
    e[0] = 0.0
    p, k = tv[:6], tv[6:]
    pe, ke = e[:6], e[6:]
    kh = norms[6:]
    for fn in ("tm_init", "tm_norm"):
        _close(getattr(tmet, fn)(to_torch(p), to_torch(pe)), getattr(jmet, fn)(jnp.asarray(p), jnp.asarray(pe)))
    jv, je = jmet.tm_normalize(jnp.asarray(p), jnp.asarray(pe))
    tv_, te = tmet.tm_normalize(to_torch(p), to_torch(pe))
    _close(tv_, jv)
    _close(te, je)
    ph = np.asarray(jmet.tm_init(jnp.asarray(p), jnp.asarray(pe)))
    _close(
        tmet.tm_nonbuilt(to_torch(p), to_torch(pe), to_torch(ph), to_torch(k), to_torch(ke), to_torch(kh)),
        jmet.tm_nonbuilt(jnp.asarray(p), jnp.asarray(pe), jnp.asarray(ph), jnp.asarray(k), jnp.asarray(ke), jnp.asarray(kh)),
    )
    jn, ja = jmet.finalize_split(jnp.asarray(p), jnp.asarray(pe), jnp.asarray(k), jnp.asarray(ke))
    tn, ta = tmet.finalize_split(to_torch(p), to_torch(pe), to_torch(k), to_torch(ke))
    if jmet.binary:  # packed normal: bit-exact
        np.testing.assert_array_equal(tb.words_to_host(tn), np.asarray(jn))
    else:
        _close(tn, jn)
    _close(ta, ja)


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(4)
    x = _vectors(rng, 9, 70)
    words = jb.pack_bits_np(x)
    np.testing.assert_array_equal(tb.pack_bits_np(x), words)
    np.testing.assert_array_equal(tb.words_to_host(tb.pack_bits(torch.from_numpy(x))), words)
    np.testing.assert_array_equal(np.asarray(jb.pack_bits_jnp(jnp.asarray(x))), words)
    for dims in (70, 128):
        np.testing.assert_array_equal(
            tb.unpack_bits(to_torch(words), dims).numpy(),
            np.asarray(jb.unpack_bits_jnp(jnp.asarray(words), dims)),
        )
    np.testing.assert_array_equal(tb.unpack_bits_full_np(words), jb.unpack_bits_full_np(words))


def test_hamming_and_bq_dot_bit_exact():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2**32, (11, 1, 6), dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 2**32, (1, 13, 6), dtype=np.uint64).astype(np.uint32)
    u[0] = 0xFFFFFFFF  # all-ones words: the sign bit of the int32 view
    np.testing.assert_array_equal(
        tb.hamming_rowwise(to_torch(u), to_torch(v)).numpy(),
        np.asarray(jb.hamming_rowwise(jnp.asarray(u), jnp.asarray(v))),
    )
    np.testing.assert_array_equal(
        tb.bq_dot_rowwise(to_torch(u), to_torch(v)).numpy(),
        np.asarray(jb.bq_dot_rowwise(jnp.asarray(u), jnp.asarray(v))),
    )


def test_sign_bit_semantics():
    x = torch.tensor([0.0, -0.0, 1.0, -1.0, float("inf"), -float("inf")])
    assert tm._sign_positive(x).tolist() == [True, False, True, False, True, False]
    np.testing.assert_array_equal(
        tm._sign_positive(x).numpy(), np.asarray(jm._sign_positive(jnp.asarray(x.numpy())))
    )


def test_dot_product_preprocess():
    rng = np.random.default_rng(6)
    x = _vectors(rng, 20)
    for a, b in zip(tm.DotProduct.preprocess_np(x), jm.DotProduct.preprocess_np(x)):
        np.testing.assert_array_equal(a, b)


def test_registry_and_storage():
    for jmet in jm.ALL_METRICS:
        tmet = tm.metric_by_name(jmet.name)
        assert tmet.storage_dim(D) == jmet.storage_dim(D)
        assert (tmet.binary, tmet.tm_cosine, tmet.has_extra) == (jmet.binary, jmet.tm_cosine, jmet.has_extra)
        assert tmet.default_oversampling == jmet.default_oversampling
    with pytest.raises(ValueError):
        tm.metric_by_name("no such distance")
