"""The seven arroy distance metrics as batched PyTorch ops.

Counterpart of `arroy_tpu/metrics.py`, method for method: every function
works over *batches* of vectors (broadcasting), so the forest build's
side assignment and the exact engine's re-score are a handful of tensor
ops on whatever device the inputs live on.

======================  =========  ==========================================
metric                  storage    margin(n, q)              built_distance
======================  =========  ==========================================
euclidean               f32        bias + n·q                Σ (p-q)²
manhattan               f32        bias + n·q                Σ |p-q|
cosine                  f32        n·q                       (1-cos)/2
dot-product             f32        n·q + nₑqₑ                -p·q
bq euclidean            bits       bias + bqdot(n,q)         4·hamming
bq manhattan            bits       bias + bqdot(n,q)         2·hamming
bq cosine               bits       bqdot(n,q)                (1-bqcos)/2
======================  =========  ==========================================

The unified formula used by the builder is
``margin = base_dot(normal, q) + aux * qf`` (see the JAX package).
Binary-quantized storage rows are int32 bit patterns on the device
(`ops/binary.py`); host encode/decode stays uint32 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.binary import (
    bq_dot_rowwise,
    hamming_rowwise,
    pack_bits,
    pack_bits_np,
    padded_dim,
    unpack_bits,
    unpack_bits_np,
)

_F32_EPSILON = float(np.finfo(np.float32).eps)
_F32_MIN_POSITIVE = float(np.finfo(np.float32).tiny)


def _sign_positive(x: torch.Tensor) -> torch.Tensor:
    """f32 `is_sign_positive()`: a sign-BIT test, so -0.0 is negative."""
    return ~torch.signbit(x.to(torch.float32))


def _safe(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, torch.ones_like(x))


class Metric:
    """Static-method bundle describing one distance (reference Distance trait)."""

    name: str = "?"
    #: query-time search_k multiplier
    default_oversampling: int = 1
    #: vectors stored as packed sign bits instead of f32
    binary: bool = False
    #: two-means normalizes its centroids
    tm_cosine: bool = False
    #: items carry a Bachrach extra coordinate (dot-product only)
    has_extra: bool = False

    # -- storage ------------------------------------------------------
    @classmethod
    def storage_dim(cls, dims: int) -> int:
        raise NotImplementedError

    @classmethod
    def encode_np(cls, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def decode_np(cls, rows: np.ndarray, dims: int) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def item_norms_np(cls, rows: np.ndarray, dims: int) -> np.ndarray:
        """Per-item header norm computed when the item is written."""
        return np.zeros(rows.shape[:-1], dtype=np.float32)

    # -- unified margin pieces ----------------------------------------
    @classmethod
    def base_dot(cls, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def margin(cls, normals, aux, q, qf) -> torch.Tensor:
        return cls.base_dot(normals, q) + aux * qf

    @classmethod
    def margin_matrix(cls, normals, aux, qv, qf) -> torch.Tensor:
        """All margins of a query batch against every split plane: [B, S]."""
        base = cls.base_dot(normals[None, :, :], qv[:, None, :])
        return base + aux[None, :] * qf[:, None]

    # -- built distance + normalization (query re-score) ---------------
    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def normalized_distance(cls, d: torch.Tensor, dims: int) -> torch.Tensor:
        return torch.sqrt(torch.clamp(d, min=0.0))

    # -- two-means training space -------------------------------------
    @classmethod
    def tm_dim(cls, dims: int) -> int:
        return dims

    @classmethod
    def tm_decode(cls, rows: torch.Tensor, dims: int) -> torch.Tensor:
        return rows

    @classmethod
    def tm_nonbuilt(cls, pv, pe, ph, kv, ke, kh) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def tm_init(cls, v, e) -> torch.Tensor:
        return torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)

    @classmethod
    def tm_norm(cls, v, e) -> torch.Tensor:
        return torch.sqrt(torch.sum(v * v, dim=-1))

    @classmethod
    def tm_normalize(cls, v, e):
        n = cls.tm_norm(v, e)
        ok = n > 0.0
        return torch.where(ok[..., None], v / _safe(n, ok)[..., None], v), e

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        """Centroids → (normal storage row, aux scalar)."""
        raise NotImplementedError


class _F32Metric(Metric):
    binary = False

    @classmethod
    def storage_dim(cls, dims: int) -> int:
        return dims

    @classmethod
    def encode_np(cls, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32)

    @classmethod
    def decode_np(cls, rows: np.ndarray, dims: int) -> np.ndarray:
        return np.asarray(rows[..., :dims], dtype=np.float32)

    @classmethod
    def base_dot(cls, a, b):
        return torch.sum(a * b, dim=-1)

    @classmethod
    def margin_matrix(cls, normals, aux, qv, qf):
        return qv @ normals.T + aux[None, :] * qf[:, None]


class _BQMetric(Metric):
    """Shared machinery of the three binary-quantized metrics."""

    binary = True
    default_oversampling = 3

    @classmethod
    def storage_dim(cls, dims: int) -> int:
        return padded_dim(dims) // 32

    @classmethod
    def encode_np(cls, x: np.ndarray) -> np.ndarray:
        return pack_bits_np(x)

    @classmethod
    def decode_np(cls, rows: np.ndarray, dims: int) -> np.ndarray:
        return unpack_bits_np(rows, dims)

    @classmethod
    def base_dot(cls, a, b):
        return bq_dot_rowwise(a, b)

    @classmethod
    def margin_matrix(cls, normals, aux, qv, qf):
        # chunk the [B, S, w] XOR broadcast along S to bound the temporary
        chunk = 2048
        base = torch.cat(
            [
                bq_dot_rowwise(normals[None, s : s + chunk, :], qv[:, None, :])
                for s in range(0, normals.shape[0], chunk)
            ],
            dim=1,
        )
        return base + aux[None, :] * qf[:, None]

    @classmethod
    def tm_dim(cls, dims: int) -> int:
        return padded_dim(dims)

    @classmethod
    def tm_decode(cls, rows, dims):
        return unpack_bits(rows, padded_dim(dims))


# ---------------------------------------------------------------------------
# f32 metrics
# ---------------------------------------------------------------------------


class Euclidean(_F32Metric):
    """Squared L2 re-score (plain sum of squared differences), mean-difference
    hyperplanes."""

    name = "euclidean"

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        diff = X - qv
        return torch.sum(diff * diff, dim=-1)

    @classmethod
    def tm_nonbuilt(cls, pv, pe, ph, kv, ke, kh):
        diff = pv - kv
        return torch.sum(diff * diff, dim=-1)

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        n = pv - qv
        norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
        ok = norm > 0.0
        n = torch.where(ok, n / _safe(norm, ok), n)
        bias = torch.sum(-n * (pv + qv) / 2.0, dim=-1)
        return n, bias


class Manhattan(_F32Metric):
    """L1 re-score; same hyperplane construction as Euclidean."""

    name = "manhattan"

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        return torch.sum(torch.abs(X - qv), dim=-1)

    @classmethod
    def normalized_distance(cls, d, dims):
        return torch.clamp(d, min=0.0)

    @classmethod
    def tm_nonbuilt(cls, pv, pe, ph, kv, ke, kh):
        return torch.sum(torch.abs(pv - kv), dim=-1)

    finalize_split = Euclidean.finalize_split


class Cosine(_F32Metric):
    """Angular distance ``(1 - cos)/2`` with clamped cosine."""

    name = "cosine"
    tm_cosine = True

    @classmethod
    def item_norms_np(cls, rows, dims):
        return np.sqrt(
            np.einsum("...d,...d->...", rows, rows, dtype=np.float64)
        ).astype(np.float32)

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        pq = torch.sum(X * qv, dim=-1)
        pnqn = Xn * qn
        ok = pnqn > _F32_EPSILON
        cos = torch.clamp(pq / _safe(pnqn, ok), -1.0, 1.0)
        return torch.where(ok, (1.0 - cos) / 2.0, torch.zeros_like(cos))

    @classmethod
    def normalized_distance(cls, d, dims):
        return d

    @classmethod
    def tm_init(cls, v, e):
        return torch.sqrt(torch.sum(v * v, dim=-1))

    @classmethod
    def tm_nonbuilt(cls, pv, pe, ph, kv, ke, kh):
        pq = torch.sum(pv * kv, dim=-1)
        pnqn = ph * kh
        ok = pnqn > _F32_EPSILON
        cos = torch.clamp(pq / _safe(pnqn, ok), -1.0, 1.0)
        return torch.where(ok, (1.0 - cos) / 2.0, torch.zeros_like(cos))

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        n = pv - qv
        norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
        ok = norm > 0.0
        n = torch.where(ok, n / _safe(norm, ok), n)
        return n, torch.zeros(n.shape[:-1], dtype=torch.float32, device=n.device)


class DotProduct(_F32Metric):
    """Inner-product search via the Bachrach et al. cosine-space reduction."""

    name = "dot-product"
    tm_cosine = True
    has_extra = True

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        return -torch.sum(X * qv, dim=-1)

    @classmethod
    def normalized_distance(cls, d, dims):
        return -d

    @classmethod
    def tm_init(cls, v, e):
        return torch.sum(v * v, dim=-1)

    @classmethod
    def tm_norm(cls, v, e):
        return torch.sqrt(torch.sum(v * v, dim=-1) + e * e)

    @classmethod
    def tm_normalize(cls, v, e):
        n = cls.tm_norm(v, e)
        ok = n > 0.0
        safe = _safe(n, ok)
        return (
            torch.where(ok[..., None], v / safe[..., None], v),
            torch.where(ok, e / safe, e),
        )

    @classmethod
    def tm_nonbuilt(cls, pv, pe, ph, kv, ke, kh):
        pq = torch.sum(pv * kv, dim=-1) + pe * ke
        ppqq = ph * kh
        return torch.where(
            ppqq >= _F32_MIN_POSITIVE,
            2.0 - 2.0 * pq / torch.sqrt(_safe(ppqq, ppqq > 0.0)),
            torch.full_like(pq, 2.0),
        )

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        n = pv - qv
        ne = pe - qe
        norm = torch.sqrt(torch.sum(n * n, dim=-1) + ne * ne)
        ok = norm > 0.0
        safe = _safe(norm, ok)
        n = torch.where(ok[..., None], n / safe[..., None], n)
        ne = torch.where(ok, ne / safe, ne)
        return n, ne

    @staticmethod
    def preprocess_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Bachrach preprocess: ``norm = max²``, ``extra = sqrt(max² - ‖v‖²)``."""
        sq = np.sum(vectors.astype(np.float32) ** 2, axis=-1, dtype=np.float32)
        norms = np.sqrt(sq)
        max_norm = np.float32(norms.max(initial=0.0))
        diff = np.maximum(max_norm * max_norm - sq, 0.0)
        return (
            np.full(sq.shape, max_norm * max_norm, dtype=np.float32),
            np.sqrt(diff).astype(np.float32),
        )


# ---------------------------------------------------------------------------
# binary quantized metrics
# ---------------------------------------------------------------------------


def _signs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(_sign_positive(x), 1.0, -1.0)


class BinaryQuantizedEuclidean(_BQMetric):
    """XOR-popcount squared L2 (×4), sign-bit hyperplanes."""

    name = "binary quantized euclidean"

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        return (4 * hamming_rowwise(X, qv)).to(torch.float32)

    @classmethod
    def normalized_distance(cls, d, dims):
        return d / dims

    tm_nonbuilt = Euclidean.tm_nonbuilt

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        # the bias uses the quantized ±1 normal and centroids, like the
        # reference's bit-codec round trip
        diff = pv - qv
        bias = torch.sum(-_signs(diff) * (_signs(pv) + _signs(qv)) / 2.0, dim=-1)
        return pack_bits(diff), bias


class BinaryQuantizedManhattan(_BQMetric):
    """XOR-popcount L1 (×2)."""

    name = "binary quantized manhattan"

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        return (2 * hamming_rowwise(X, qv)).to(torch.float32)

    @classmethod
    def normalized_distance(cls, d, dims):
        return torch.clamp(d, min=0.0) / dims

    tm_nonbuilt = Manhattan.tm_nonbuilt
    finalize_split = BinaryQuantizedEuclidean.finalize_split


class BinaryQuantizedCosine(_BQMetric):
    """±1 angular distance via XNOR popcount (no cosine clamp, like the
    reference)."""

    name = "binary quantized cosine"
    tm_cosine = True

    @classmethod
    def item_norms_np(cls, rows, dims):
        d_pad = rows.shape[-1] * 32
        return np.full(rows.shape[:-1], np.sqrt(np.float32(d_pad)), dtype=np.float32)

    @classmethod
    def built_distance(cls, qv, qn, qe, X, Xn, Xe):
        pq = bq_dot_rowwise(X, qv)
        pnqn = Xn * qn
        ok = pnqn != 0.0
        cos = pq / _safe(pnqn, ok)
        return torch.where(ok, (1.0 - cos) / 2.0, torch.zeros_like(cos))

    @classmethod
    def normalized_distance(cls, d, dims):
        return d

    tm_init = Cosine.tm_init
    tm_nonbuilt = Cosine.tm_nonbuilt

    @classmethod
    def finalize_split(cls, pv, pe, qv, qe):
        diff = pv - qv
        return pack_bits(diff), torch.zeros(
            diff.shape[:-1], dtype=torch.float32, device=diff.device
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ALL_METRICS = (
    Euclidean,
    Manhattan,
    Cosine,
    DotProduct,
    BinaryQuantizedEuclidean,
    BinaryQuantizedManhattan,
    BinaryQuantizedCosine,
)

_BY_NAME = {m.name: m for m in ALL_METRICS}


def metric_by_name(name: str) -> type[Metric]:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown distance {name!r}; expected one of {sorted(_BY_NAME)}"
        ) from None


def resolve_metric(metric) -> type[Metric]:
    if isinstance(metric, str):
        return metric_by_name(metric)
    if isinstance(metric, type) and issubclass(metric, Metric):
        return metric
    raise TypeError(f"not a metric: {metric!r}")
