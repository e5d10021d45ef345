"""Exact-engine stage 1: fused score + per-block top-2 select.

Counterpart of `arroy_tpu/ops/pallas_exact.py`.  For every query and
every bm-row corpus block it keeps the two best *packed keys*:

    score[b, m] = dot(q[b], x[m]) * (qsc[b] * mult[m]) + add[m]
    i    = bitcast<i32>(score)
    skey = i >= 0 ? i : i ^ 0x7fffffff     # IEEE total order as signed i32
    key  = (skey & -bm) | lane             # low log2(bm) bits carry the lane

Keys order like scores except within one value quantum; dead/padded
slots score -inf and pack at or below `DEAD_KEY_MAX`.  Outputs are
block-major ``[max_0..max_nb-1, second_0..second_nb-1]`` so stage 2 can
cut them to ``c`` candidates by key order.

`fused_block_select` dispatches on where its tensors live: on a CUDA
device it launches the hand-written kernel (`csrc/fused_select.cu`) or
raises; on the CPU it runs `fused_block_select_reference`, the plain
PyTorch version that materializes ``[B, M]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

#: corpus rows per block == one select bin (pow2)
DEFAULT_BM = 256
#: blocks per padding group: corpora are padded to a multiple of
#: bm * gp exactly as the JAX package pads them, so both packages lay
#: out bit-identical tables
DEFAULT_GP = 8

#: any packed key <= this marks a dead / padded slot (score -inf)
DEAD_KEY_MAX = int(
    np.int32(np.float32(float("-inf")).view(np.int32)) ^ np.int32(0x7FFFFFFF)
)  # == i32(0x807fffff)

#: kernel launches on the card, per instantiation (test/smoke observability)
launches = {"fused_select_int8": 0, "fused_select_bf16": 0}

_INT_MIN = -(2**31)


def _pack_keys(s: torch.Tensor, lane: torch.Tensor, bm: int) -> torch.Tensor:
    """Monotonic sortable i32 keys with the low log2(bm) bits = lane."""
    i = s.to(torch.float32).contiguous().view(torch.int32)
    skey = torch.where(i >= 0, i, i ^ 0x7FFFFFFF)
    return (skey & -bm) | lane


def fused_block_select_reference(q, x, qsc, mult, add, bm: int = DEFAULT_BM):
    """Plain PyTorch version (materializes [B, M]).

    int8 dots are taken in float64, which is exact for any realistic d
    (|dot| <= 127² · d < 2^53) — ``int8 @ int8`` would overflow in int8
    on the CPU and integer matmul does not exist on CUDA; bf16 dots are
    an f32 matmul of the bf16 values."""
    if q.dtype == torch.int8:
        dots = (q.double() @ x.double().T).to(torch.int32).to(torch.float32)
    else:
        dots = q.float() @ x.float().T
    s = dots * (qsc[:, None] * mult[None, :]) + add[None, :]
    b, mp = s.shape
    nb = mp // bm
    lane = torch.arange(bm, dtype=torch.int32, device=s.device)
    pk = _pack_keys(s.reshape(b, nb, bm), lane, bm)
    m1 = pk.amax(dim=2)
    pk2 = torch.where(pk == m1[:, :, None], _INT_MIN, pk)
    m2 = pk2.amax(dim=2)
    keys = torch.cat([m1, m2], dim=1)
    base = (torch.arange(2 * nb, dtype=torch.int32, device=s.device) % nb) * bm
    idx = (keys & (bm - 1)) + base[None, :]
    return keys, idx


def _lib():
    lib = _build.load("fused_select")
    for fn in (lib.fused_select_int8, lib.fused_select_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def fused_block_select(q, x, qsc, mult, add, bm: int = DEFAULT_BM):
    """Stage-1 fused select: per-block top-2 packed keys for every query.

    q:    [B, d]  int8 or bfloat16 queries (d a multiple of 128)
    x:    [Mp, d] corpus rows, same dtype, Mp a multiple of bm
    qsc:  [B]   f32 per-query dequant scale (ones for bf16)
    mult: [Mp]  f32 per-item score multiplier
    add:  [Mp]  f32 per-item additive term (-inf for dead/pad slots)

    Returns (keys [B, 2*nb] int32, idx [B, 2*nb] int32), nb = Mp // bm.
    """
    if q.device.type == "cpu":
        return fused_block_select_reference(q, x, qsc, mult, add, bm)
    if q.device.type != "cuda":
        raise ValueError(f"fused_block_select: unsupported device {q.device}")
    b, d = q.shape
    mp = x.shape[0]
    if q.dtype not in (torch.int8, torch.bfloat16) or x.dtype != q.dtype:
        raise TypeError(f"fused_block_select: q/x must share int8 or bf16, got {q.dtype}/{x.dtype}")
    if any(t.dtype != torch.float32 for t in (qsc, mult, add)):
        raise TypeError("fused_block_select: qsc, mult and add must be float32")
    if x.shape[1] != d or d % 128 or qsc.shape != (b,) or mult.shape != (mp,) or add.shape != (mp,):
        raise ValueError(
            f"fused_block_select: bad shapes q{tuple(q.shape)} x{tuple(x.shape)} "
            f"qsc{tuple(qsc.shape)} mult{tuple(mult.shape)} add{tuple(add.shape)}"
        )
    if bm % 256 or bm & (bm - 1) or mp % bm:
        raise ValueError(f"fused_block_select: bm={bm} must be a pow2 multiple of 256 dividing Mp={mp}")
    tensors = (q, x, qsc, mult, add)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_block_select: tensors must be contiguous on one device")
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("fused_block_select: q and x must be 16-byte aligned (TMA)")
    nb = mp // bm
    keys = torch.empty((b, 2 * nb), dtype=torch.int32, device=q.device)
    idx = torch.empty((b, 2 * nb), dtype=torch.int32, device=q.device)
    if b == 0:
        return keys, idx
    name = "fused_select_int8" if q.dtype == torch.int8 else "fused_select_bf16"
    fn = getattr(_lib(), name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), keys.data_ptr(), idx.data_ptr(),
                b, mp, d, bm, stream)
    _build.check(rc, name)
    launches[name] += 1
    return keys, idx
