"""Leaf-probe stage 2: score each query's selected blocks.

Counterpart of `arroy_tpu/ops/pallas_probe.py`.  For every query ``b``
and each of its ``C`` selected block ids::

    out[b, c, p] = Σ_d f32(blk_rows[bid[b, c], p, d]) · qv[b, d]

with f32 accumulation.  `gather_score` dispatches on where its tensors
live: on a CUDA device it launches the hand-written kernel
(`csrc/gather_score.cu`) or raises; on the CPU it runs
`gather_score_reference`, the plain PyTorch version (gather + einsum,
chunked over C).  Rows may be bf16, f32 or int8; int8 dequantization
happens outside, as the caller multiplies by the per-item scale.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches on the card, per row type (test/smoke observability)
launches = {"gather_score_bf16": 0, "gather_score_int8": 0, "gather_score_f32": 0}

#: bytes of the [B, c, P, d] f32 gathered temporary in the plain version
_REF_CHUNK_BYTES = 256 << 20
#: widest query the kernel's static-launch shared memory holds (f32)
_MAX_DIM = (48 << 10) // 4
#: row dtype -> (the kernel's row_type code, launch counter name)
_ROW_TYPES = {
    torch.float32: (0, "gather_score_f32"),
    torch.bfloat16: (1, "gather_score_bf16"),
    torch.int8: (2, "gather_score_int8"),
}


def gather_score_reference(blk_rows: torch.Tensor, bid: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [NBT, P, d] rows, [B, C] ids, [B, d] f32 -> [B, C, P] f32."""
    b, c = bid.shape
    _, p, d = blk_rows.shape
    step = max(_REF_CHUNK_BYTES // max(b * p * d * 4, 1), 1)
    out = torch.empty((b, c, p), dtype=torch.float32, device=qv.device)
    for s in range(0, c, step):
        rows = blk_rows[bid[:, s : s + step].long()].float()
        out[:, s : s + step] = torch.einsum("bcpd,bd->bcp", rows, qv)
    return out


def _lib():
    lib = _build.load("gather_score")
    lib.gather_score.restype = ctypes.c_int
    lib.gather_score.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    return lib


def _vec_bytes(blk_rows: torch.Tensor) -> int:
    """Widest load (16, 8, 4, 2 or 1 bytes) that divides a row and the base."""
    row_bytes = blk_rows.shape[2] * blk_rows.element_size()
    for vb in (16, 8, 4, 2, 1):
        if vb >= blk_rows.element_size() and row_bytes % vb == 0 and blk_rows.data_ptr() % vb == 0:
            return vb
    raise ValueError("gather_score: rows are not aligned to their element size")


def gather_score(blk_rows: torch.Tensor, bid: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Score per-query selected blocks against the queries.

    blk_rows: [NBT, P, d] bf16 / f32 / int8 block tables
    bid:      [B, C] int32 block ids, already clamped to [0, NBT)
    qv:       [B, d] f32 queries
    returns:  [B, C, P] f32 raw dots ``q_b · row`` (no aux terms)
    """
    if blk_rows.device.type == "cpu":
        return gather_score_reference(blk_rows, bid, qv)
    if blk_rows.device.type != "cuda":
        raise ValueError(f"gather_score: unsupported device {blk_rows.device}")
    if blk_rows.dtype not in _ROW_TYPES:
        raise TypeError(f"gather_score: rows must be bf16, f32 or int8, got {blk_rows.dtype}")
    if bid.dtype != torch.int32 or qv.dtype != torch.float32:
        raise TypeError(f"gather_score: bid must be int32 and qv float32, got {bid.dtype}/{qv.dtype}")
    if blk_rows.dim() != 3 or bid.dim() != 2 or qv.dim() != 2:
        raise ValueError("gather_score: expected rows [NBT, P, d], bid [B, C], qv [B, d]")
    nbt, p, d = blk_rows.shape
    b, c = bid.shape
    if qv.shape != (b, d) or d > _MAX_DIM:
        raise ValueError(
            f"gather_score: bad shapes rows{tuple(blk_rows.shape)} bid{tuple(bid.shape)} "
            f"qv{tuple(qv.shape)}"
        )
    tensors = (blk_rows, bid, qv)
    if any(t.device != blk_rows.device or not t.is_contiguous() for t in tensors):
        raise ValueError("gather_score: tensors must be contiguous on one device")
    out = torch.empty((b, c, p), dtype=torch.float32, device=blk_rows.device)
    if out.numel() == 0:
        return out
    row_type, name = _ROW_TYPES[blk_rows.dtype]
    with torch.cuda.device(blk_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gather_score(row_type, _vec_bytes(blk_rows), blk_rows.data_ptr(),
                                 bid.data_ptr(), qv.data_ptr(), out.data_ptr(),
                                 b, c, p, d, nbt, stream)
    _build.check(rc, name)
    launches[name] += 1
    return out
