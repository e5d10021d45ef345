"""Low-level device ops: packing, popcounts and the two hand-written kernels
(`fused_select`, `bq_kernels`; built by `_build` from ``csrc/``)."""

from .binary import (
    bq_dot_rowwise,
    hamming_rowwise,
    pack_bits,
    pack_bits_np,
    padded_dim,
    popcount32,
    unpack_bits,
    unpack_bits_full_np,
    unpack_bits_np,
)

__all__ = [
    "bq_dot_rowwise",
    "hamming_rowwise",
    "pack_bits",
    "pack_bits_np",
    "padded_dim",
    "popcount32",
    "unpack_bits",
    "unpack_bits_full_np",
    "unpack_bits_np",
]
