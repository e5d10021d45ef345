"""Leaf-probe stage 2: score each query's selected blocks.

Counterpart of `arroy_tpu/ops/pallas_probe.py`.  For every query ``b``
and each of its ``C`` selected block ids::

    out[b, c, p] = Σ_d f32(blk_rows[bid[b, c], p, d]) · qv[b, d]

with f32 accumulation.  `gather_score` dispatches on where its tensors
live: on a CUDA device it launches the hand-written kernel
(`csrc/gather_score.cu`: for a call that gathers `SCHEDULE_MIN_BYTES` or
more, a counting sort of the pairs by block id, then the scoring, which
reads each distinct block once) or raises; on the CPU it runs
`gather_score_reference`, the plain PyTorch version (gather + einsum,
chunked over C).  Rows may be bf16, f32 or int8; int8 dequantization
happens outside, as the caller multiplies by the per-item scale.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

#: kernel launches on the card, per row type (test/smoke observability)
launches = {"gather_score_bf16": 0, "gather_score_int8": 0, "gather_score_f32": 0}

#: bytes of the [B, c, P, d] f32 gathered temporary in the plain version
_REF_CHUNK_BYTES = 256 << 20
#: scheduled pairs one CTA of the kernel takes (`kSlice` in the source)
SLICE = 32
#: least rows a call gathers (B*C*P*d*itemsize bytes) for which the kernel
#: sorts the pairs by block first.  The sort costs ~0.012 ms a call on an
#: NVIDIA H100 80GB HBM3 at 700 W (`scripts/torch_gather_tune.py`, PERF.md):
#: it paid on the probe slice's 352 MB bf16 and 503 MB f32 chunks and lost
#: on its 264 MB int8 chunks; below, the pairs are scored in query order.
SCHEDULE_MIN_BYTES = 300 << 20
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


def block_schedule(bid: torch.Tensor, nbt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work order: the [B*C] block ids sorted and, beside each,
    the flat pair index b*C + c it came from, both int32, so the pairs that
    share a block are neighbours.  On the card this is the kernel's own
    schedule (a counting sort; the order of the pairs within a block may
    differ from run to run), on the CPU `torch.sort`."""
    flat = bid.reshape(-1)
    if flat.device.type == "cpu":
        keys, pairs = torch.sort(flat)
        return keys, pairs.to(torch.int32)
    n = flat.numel()
    scratch = torch.empty(2 * n + nbt + 1, dtype=torch.int32, device=flat.device)
    if n:
        with torch.cuda.device(flat.device):
            rc = _lib().gather_schedule(flat.data_ptr(), n, nbt, scratch.data_ptr(),
                                        scratch[n:].data_ptr(), scratch[2 * n:].data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "gather_schedule")
    return scratch[:n], scratch[n : 2 * n]


def block_reads(keys: torch.Tensor) -> int:
    """How many blocks the kernel reads for a schedule: one per run of
    equal ids within each slice of `SLICE` scheduled pairs."""
    first = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    first[::SLICE] = True
    return int(first.sum())


def _lib():
    lib = _build.load("gather_score")
    lib.gather_score.restype = ctypes.c_int
    lib.gather_score.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    )
    lib.gather_schedule.restype = ctypes.c_int
    lib.gather_schedule.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    return lib


def _vec_bytes(blk_rows: torch.Tensor) -> int:
    """Bytes per load: of the widths (16, 8, 4, 2, 1) that divide a row and
    the base, the one that gives a lane the fewest bytes of a row (no lane
    idles where a row is a multiple of 32 vectors), the widest on a tie."""
    es = blk_rows.element_size()
    row_bytes = blk_rows.shape[2] * es
    fits = [vb for vb in (16, 8, 4, 2, 1)
            if vb >= es and row_bytes % vb == 0 and blk_rows.data_ptr() % vb == 0]
    if not fits:
        raise ValueError("gather_score: rows are not aligned to their element size")
    return min(fits, key=lambda vb: (-(-row_bytes // (32 * vb)) * vb, -vb))


def work(blk_rows: torch.Tensor, bid: torch.Tensor) -> dict:
    """The work record of one call (`utils.profiling.counting`): B, C, P,
    d, the rows' type and element bytes, and ``blocks``, the distinct block
    ids in `bid`: the blocks a call must read."""
    b, c = bid.shape
    _, p, d = blk_rows.shape
    return {"kernel": "gather_score", "B": b, "C": c, "P": p, "d": d,
            "dtype": str(blk_rows.dtype).removeprefix("torch."),
            "elem_bytes": blk_rows.element_size(), "blocks": int(torch.unique(bid).numel())}


def gather_score(blk_rows: torch.Tensor, bid: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Score per-query selected blocks against the queries.

    blk_rows: [NBT, P, d] bf16 / f32 / int8 block tables
    bid:      [B, C] int32 block ids, already clamped to [0, NBT)
    qv:       [B, d] f32 queries
    returns:  [B, C, P] f32 raw dots ``q_b · row`` (no aux terms)
    """
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work(blk_rows, bid))
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
    if qv.shape != (b, d):
        raise ValueError(
            f"gather_score: bad shapes rows{tuple(blk_rows.shape)} bid{tuple(bid.shape)} "
            f"qv{tuple(qv.shape)}"
        )
    tensors = (blk_rows, bid, qv)
    if any(t.device != blk_rows.device or not t.is_contiguous() for t in tensors):
        raise ValueError("gather_score: tensors must be contiguous on one device")
    if b * c * p == 0 or d == 0:
        return torch.zeros((b, c, p), dtype=torch.float32, device=blk_rows.device)
    if qv.data_ptr() % 16:  # the kernel reads the query in 16-byte vectors
        qv = qv.clone()
    out = torch.empty((b, c, p), dtype=torch.float32, device=blk_rows.device)
    row_type, name = _ROW_TYPES[blk_rows.dtype]
    scratch = None
    if b * c * p * d * blk_rows.element_size() >= SCHEDULE_MIN_BYTES:
        scratch = torch.empty(2 * b * c + nbt + 1, dtype=torch.int32, device=blk_rows.device)
    with torch.cuda.device(blk_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gather_score(row_type, _vec_bytes(blk_rows), blk_rows.data_ptr(),
                                 bid.data_ptr(), qv.data_ptr(), out.data_ptr(), b, c, p, d, nbt,
                                 stream, None if scratch is None else scratch.data_ptr())
    _build.check(rc, name)
    launches[name] += 1
    return out
