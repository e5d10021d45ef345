"""Low-level device ops: packing, popcounts and the six hand-written
kernels (`fused_select`, `bq_kernels`, `gather_score`, `traverse`,
`rescore`, `rank_select`; built by `_build` from ``csrc/``)."""

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
from .rescore import cut_rescore, rescore_topk

__all__ = [
    "bq_dot_rowwise",
    "cut_rescore",
    "hamming_rowwise",
    "pack_bits",
    "pack_bits_np",
    "padded_dim",
    "popcount32",
    "rescore_topk",
    "unpack_bits",
    "unpack_bits_full_np",
    "unpack_bits_np",
]
