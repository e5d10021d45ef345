"""Binary-quantized vector packing and popcount dot products (PyTorch).

Counterpart of `arroy_tpu/ops/binary.py`.  The host-side numpy codec is
the reference's, copied verbatim, so packed words are bit-identical in
both packages and on disk.

On the device, packed words are held as **int32 bit patterns**
(``np.ndarray.view(np.int32)``): PyTorch's uint32 support is partial
(no right shift on the CPU, no popcount op at all).  Bit extraction
therefore works on int32 with masks, and popcount is the SWAR bit trick
on int64 after ``& 0xFFFFFFFF``.

* ``bq_dot(u, v)   = d_pad - 2 * hamming(u, v)``  (±1 dot product)
* ``bq_euclidean   = 4 * hamming``
* ``bq_manhattan   = 2 * hamming``
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
#: pad dimensions to a multiple of 64 bits to match the reference's u64 words
PAD_BITS = 64


def padded_dim(dims: int) -> int:
    """Number of stored bits for a `dims`-dimensional BQ vector."""
    return ((dims + PAD_BITS - 1) // PAD_BITS) * PAD_BITS


# ---------------------------------------------------------------------------
# host-side pack / unpack (numpy) — identical to arroy_tpu.ops.binary
# ---------------------------------------------------------------------------

def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """Pack float vectors ``[..., d]`` into sign-bit words ``[..., w]`` (uint32).

    Bit = 1 iff the float's sign bit is clear (+0.0 → 1, -0.0 → 0);
    padding bits are 0.  LSB-first: dim k lives in word ``k // 32`` bit
    ``k % 32``.
    """
    x = np.asarray(x, dtype=np.float32)
    d = x.shape[-1]
    dp = padded_dim(d)
    bits = ~np.signbit(x)
    padded = np.zeros(x.shape[:-1] + (dp,), dtype=bool)
    padded[..., :d] = bits
    b = padded.reshape(*padded.shape[:-1], dp // WORD_BITS, WORD_BITS)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    return (b.astype(np.uint32) * weights).sum(axis=-1, dtype=np.uint32)


def unpack_bits_np(words: np.ndarray, dims: int) -> np.ndarray:
    """Decode packed words back to ±1.0 float vectors of length ``dims``."""
    words = np.asarray(words, dtype=np.uint32)
    w = words.shape[-1]
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    flat = bits.reshape(*words.shape[:-1], w * WORD_BITS)[..., :dims]
    return np.where(flat.astype(bool), np.float32(1.0), np.float32(-1.0))


def unpack_bits_full_np(words: np.ndarray) -> np.ndarray:
    """Decode to ±1.0 over the FULL padded width (padding bits → -1.0)."""
    w = np.asarray(words, dtype=np.uint32).shape[-1]
    return unpack_bits_np(words, w * WORD_BITS)


# ---------------------------------------------------------------------------
# device-side ops (torch, int32 bit patterns)
# ---------------------------------------------------------------------------

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (SWAR), as int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_rowwise(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """popcount(u ^ v) summed over the last axis. Shapes broadcast."""
    return popcount32(torch.bitwise_xor(u, v)).sum(dim=-1, dtype=torch.int32)


def bq_dot_rowwise(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """±1 dot product over the padded width, as f32 (``d_pad - 2·hamming``)."""
    d_pad = u.shape[-1] * WORD_BITS
    return (d_pad - 2 * hamming_rowwise(u, v)).to(torch.float32)


def unpack_bits(words: torch.Tensor, dims: int) -> torch.Tensor:
    """Device-side decode of int32 words to ±1.0 float (length ``dims``).

    An arithmetic right shift keeps bit ``s`` at position 0 for every
    ``s < 32``, so masking with 1 extracts it from negative words too."""
    w = words.shape[-1]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> shifts) & 1
    flat = bits.reshape(*words.shape[:-1], w * WORD_BITS)[..., :dims]
    return torch.where(flat.bool(), 1.0, -1.0).to(torch.float32)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Device-side sign-bit packing of float vectors ``[..., d]`` → int32 words.

    ``torch.signbit`` honours -0.0 like `is_sign_positive()`."""
    d = x.shape[-1]
    dp = padded_dim(d)
    pos = ~torch.signbit(x.to(torch.float32))
    pad = torch.zeros(x.shape[:-1] + (dp - d,), dtype=torch.bool, device=x.device)
    b = torch.cat([pos, pad], dim=-1).reshape(*x.shape[:-1], dp // WORD_BITS, WORD_BITS)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=x.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=x.device
    )
    words = (b.to(torch.int64) * weights).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def words_to_host(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor → uint32 host words."""
    return words.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
