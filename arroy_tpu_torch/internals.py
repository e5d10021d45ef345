"""Low-level access for embedding applications (the `internals` module).

Counterpart of `arroy_tpu/internals.py`, name for name.  The reference
exposes a public ``internals`` module so that its embedder (meilisearch)
can craft and decode raw leaf records, reach the vector codecs, and
implement custom distances on top of the public `Distance` trait
(reference: src/lib.rs:110-142).  This is the same surface for the
PyTorch port:

- :class:`Side` — the split-plane side enum,
- the seven per-metric node-header dataclasses (same field names as the
  reference's ``NodeHeader*`` structs),
- :class:`Leaf` — one item record as (header, storage row), with
  :func:`craft_leaf` / :func:`raw_leaf` / :func:`decode_leaf` codecs
  (the ``Leaf`` + ``UnalignedVector`` + ``NodeCodec`` roles),
- the raw bit-pack codecs (``pack_bits_np`` et al.) for binary-quantized
  storage rows,
- :func:`register_metric` — the custom-`Distance` extension point: a
  `Metric` subclass registered here resolves by name everywhere a
  built-in metric does (Writer, Reader, CLI, persistence).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

import numpy as np

from .errors import SizeMismatch
from .metrics import (
    Metric,
    register_metric,
)
from .ops.binary import (  # noqa: F401  (public re-exports, codec role)
    pack_bits_np,
    padded_dim,
    unpack_bits_np,
)


class Side(enum.Enum):
    """Which side of a split plane an item moves to
    (reference: src/lib.rs:125-142)."""

    Left = 0
    Right = 1

    @staticmethod
    def random(rng: np.random.Generator) -> "Side":
        return Side.Right if rng.random() < 0.5 else Side.Left


# ---------------------------------------------------------------------------
# node headers (reference: src/distance/*.rs NodeHeader* structs)
# ---------------------------------------------------------------------------


@dataclass
class NodeHeaderEuclidean:
    """reference: src/distance/euclidean.rs:23-26."""

    bias: float = 0.0


@dataclass
class NodeHeaderManhattan:
    """reference: src/distance/manhattan.rs:22-25."""

    bias: float = 0.0


@dataclass
class NodeHeaderCosine:
    """reference: src/distance/cosine.rs:22-24."""

    norm: float = 0.0


@dataclass
class NodeHeaderDotProduct:
    """reference: src/distance/dot_product.rs:25-29."""

    extra_dim: float = 0.0
    norm: float = 0.0


@dataclass
class NodeHeaderBinaryQuantizedEuclidean:
    """reference: src/distance/binary_quantized_euclidean.rs:25-28."""

    bias: float = 0.0


@dataclass
class NodeHeaderBinaryQuantizedManhattan:
    """reference: src/distance/binary_quantized_manhattan.rs:24-27."""

    bias: float = 0.0


@dataclass
class NodeHeaderBinaryQuantizedCosine:
    """reference: src/distance/binary_quantized_cosine.rs:24-26."""

    norm: float = 0.0


NodeHeader = Union[
    NodeHeaderEuclidean,
    NodeHeaderManhattan,
    NodeHeaderCosine,
    NodeHeaderDotProduct,
    NodeHeaderBinaryQuantizedEuclidean,
    NodeHeaderBinaryQuantizedManhattan,
    NodeHeaderBinaryQuantizedCosine,
]

_HEADER_BY_METRIC = {
    "euclidean": NodeHeaderEuclidean,
    "manhattan": NodeHeaderManhattan,
    "cosine": NodeHeaderCosine,
    "dot-product": NodeHeaderDotProduct,
    "binary quantized euclidean": NodeHeaderBinaryQuantizedEuclidean,
    "binary quantized manhattan": NodeHeaderBinaryQuantizedManhattan,
    "binary quantized cosine": NodeHeaderBinaryQuantizedCosine,
}


def header_type(metric) -> type:
    """The `Distance::Header` associated type for a metric."""
    from .metrics import resolve_metric

    m = resolve_metric(metric)
    try:
        return _HEADER_BY_METRIC[m.name]
    except KeyError:
        # custom metrics: norm-carrying generic header
        return NodeHeaderCosine


# ---------------------------------------------------------------------------
# leaves (reference: src/node.rs Leaf + NodeCodec, unaligned_vector codecs)
# ---------------------------------------------------------------------------


@dataclass
class Leaf:
    """One item record: metric header + encoded storage row.

    ``vector`` is the *storage-space* row — f32 of length `dims` for f32
    metrics, packed uint32 sign-bit words for binary-quantized metrics
    (reference: src/node.rs:45-47, src/unaligned_vector/).
    """

    header: NodeHeader
    vector: np.ndarray
    dims: int
    metric_name: str

    def to_vector(self) -> np.ndarray:
        """Decode the storage row back to user f32 space (±1.0 for BQ)."""
        from .metrics import metric_by_name

        m = metric_by_name(self.metric_name)
        return m.decode_np(self.vector[None, :], self.dims)[0]


def craft_leaf(metric, vector: np.ndarray) -> Leaf:
    """Encode a user vector into the leaf record the store would hold
    (the `Distance::craft_owned_unaligned_vector_from_f32` +
    ``new_header`` path an embedder uses to build records by hand)."""
    from .metrics import resolve_metric

    m = resolve_metric(metric)
    vector = np.asarray(vector, dtype=np.float32)
    if vector.ndim != 1:
        raise SizeMismatch(f"expected a 1-d vector, got shape {vector.shape}")
    dims = int(vector.shape[0])
    row = m.encode_np(vector[None, :])[0]
    norm = float(m.item_norms_np(row[None, :], dims)[0])
    return Leaf(
        header=_make_header(m, norm=norm, extra=0.0),
        vector=row,
        dims=dims,
        metric_name=m.name,
    )


def _make_header(m: type[Metric], norm: float, extra: float) -> NodeHeader:
    cls = header_type(m)
    if cls is NodeHeaderDotProduct:
        return cls(extra_dim=extra, norm=norm)
    if cls in (NodeHeaderCosine, NodeHeaderBinaryQuantizedCosine):
        return cls(norm=norm)
    return cls(bias=norm * 0.0)  # bias headers start at 0 for items


def raw_leaf(reader, item: int) -> Leaf | None:
    """The stored leaf record of `item` from an open Reader — raw storage
    row plus the live header fields (norm / Bachrach extra_dim), i.e.
    what the reference's ``Database::get(Key::item(..))`` returns."""
    st = reader._state
    slot = st.store._id_to_slot.get(int(item))
    if slot is None:
        return None
    m = st.metric
    return Leaf(
        header=_make_header(
            m, norm=float(st.store.norms()[slot]), extra=float(st.store.extras()[slot])
        ),
        vector=st.store.rows()[slot].copy(),
        dims=st.dims,
        metric_name=m.name,
    )


def decode_leaf(metric, row: np.ndarray, dims: int) -> np.ndarray:
    """Storage row -> user-space f32 vector (the read-side vector codec)."""
    from .metrics import resolve_metric

    m = resolve_metric(metric)
    return m.decode_np(np.asarray(row)[None, :], int(dims))[0]


__all__ = [
    "Side",
    "Leaf",
    "Metric",
    "NodeHeaderEuclidean",
    "NodeHeaderManhattan",
    "NodeHeaderCosine",
    "NodeHeaderDotProduct",
    "NodeHeaderBinaryQuantizedEuclidean",
    "NodeHeaderBinaryQuantizedManhattan",
    "NodeHeaderBinaryQuantizedCosine",
    "SizeMismatch",
    "craft_leaf",
    "decode_leaf",
    "header_type",
    "pack_bits_np",
    "padded_dim",
    "raw_leaf",
    "register_metric",
    "unpack_bits_np",
]
