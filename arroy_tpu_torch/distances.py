"""The supported distances (reference: src/lib.rs:143-149 `distances` module)."""

from .metrics import (
    ALL_METRICS,
    BinaryQuantizedCosine,
    BinaryQuantizedEuclidean,
    BinaryQuantizedManhattan,
    Cosine,
    DotProduct,
    Euclidean,
    Manhattan,
)

__all__ = [
    "ALL_METRICS",
    "BinaryQuantizedCosine",
    "BinaryQuantizedEuclidean",
    "BinaryQuantizedManhattan",
    "Cosine",
    "DotProduct",
    "Euclidean",
    "Manhattan",
]
