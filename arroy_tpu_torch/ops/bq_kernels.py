"""Binary-quantized distance matrix: ``h[b, m] = Σ_w popcount(q[b,w] ^ x[m,w])``.

Counterpart of `arroy_tpu/ops/pallas_kernels.py`.  It is the compute
core of BQ exact search.  `bq_hamming_matrix` dispatches on where its
tensors live: on a CUDA device it launches the hand-written kernel
(`csrc/hamming.cu`) or raises; on the CPU it runs
`bq_hamming_matrix_reference`, the plain PyTorch version (xor + SWAR
popcount, chunked over M).  Packed words are int32 bit patterns.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .binary import popcount32

#: kernel launches on the card (test/smoke observability)
launches = {"bq_hamming": 0}

#: bytes of the int64 [B, chunk, w] popcount temporary in the plain version
_REF_CHUNK_BYTES = 256 << 20


def bq_hamming_matrix_reference(q_words: torch.Tensor, x_words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [B, w] x [M, w] int32 words -> [B, M] int32."""
    b, w = q_words.shape
    m = x_words.shape[0]
    step = max(_REF_CHUNK_BYTES // max(b * w * 8, 1), 1)
    out = torch.empty((b, m), dtype=torch.int32, device=q_words.device)
    for s in range(0, m, step):
        xor = torch.bitwise_xor(q_words[:, None, :], x_words[None, s : s + step, :])
        out[:, s : s + step] = popcount32(xor).sum(dim=-1, dtype=torch.int32)
    return out


def _lib():
    lib = _build.load("hamming")
    lib.bq_hamming.restype = ctypes.c_int
    lib.bq_hamming.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def bq_hamming_matrix(q_words: torch.Tensor, x_words: torch.Tensor) -> torch.Tensor:
    """[B, w] x [M, w] packed sign bits -> [B, M] hamming distances (int32)."""
    if q_words.device.type == "cpu":
        return bq_hamming_matrix_reference(q_words, x_words)
    if q_words.device.type != "cuda":
        raise ValueError(f"bq_hamming_matrix: unsupported device {q_words.device}")
    b, w = q_words.shape
    m = x_words.shape[0]
    if q_words.dtype != torch.int32 or x_words.dtype != torch.int32:
        raise TypeError("bq_hamming_matrix: packed words must be int32 bit patterns")
    if x_words.shape[1] != w:
        raise ValueError(
            f"bq_hamming_matrix: bad shapes q{tuple(q_words.shape)} x{tuple(x_words.shape)}"
        )
    if x_words.device != q_words.device or not (q_words.is_contiguous() and x_words.is_contiguous()):
        raise ValueError("bq_hamming_matrix: tensors must be contiguous on one device")
    out = torch.empty((b, m), dtype=torch.int32, device=q_words.device)
    if b == 0 or m == 0 or w == 0:
        return out.zero_()
    with torch.cuda.device(q_words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().bq_hamming(q_words.data_ptr(), x_words.data_ptr(), out.data_ptr(),
                               b, m, w, stream)
    _build.check(rc, "bq_hamming")
    launches["bq_hamming"] += 1
    return out
