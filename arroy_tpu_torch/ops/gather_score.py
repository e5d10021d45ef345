"""Leaf-probe stage 2: score each query's selected blocks.

Counterpart of `arroy_tpu/ops/pallas_probe.py`.  For every query ``b``
and each of its ``C`` selected block ids::

    out[b, c, p] = Σ_d f32(blk_rows[bid[b, c], p, d]) · qv[b, d]

with f32 accumulation, and writes the probe's in-block score of that dot
(an `Epilogue`, whose plain chain is `apply_epilogue`: the int8 scale, the
metric's op and ``-inf`` where no live, matching slot is), so the probe
writes nothing but the [B, C, P] scores; the "dot" op with every slot
live writes the dots themselves.  `gather_score` dispatches on where its
tensors live: on a CUDA device it launches the hand-written kernel
(`csrc/gather_score.cu`: for a call that gathers `SCHEDULE_MIN_BYTES` or
more, a counting sort of the pairs by block id on the whole card, then
the scoring, which reads each distinct block once and writes the score)
or raises; on the CPU it runs `gather_score_reference`, the plain
PyTorch version (gather + einsum, chunked over C, then the epilogue's
chain of elementwise ops).  Rows may be bf16, f32 or int8.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..utils import profiling
from . import _build

#: kernel launches on the card, per row type (test/smoke observability)
launches = {"gather_score_bf16": 0, "gather_score_int8": 0, "gather_score_f32": 0}

#: bytes of the [B, c, P, d] f32 gathered temporary in the plain version
_REF_CHUNK_BYTES = 256 << 20
#: scheduled pairs one CTA of the kernel takes (`kSlice` in the source)
SLICE = 32
#: block counts one CTA of the schedule's scan takes (`kScanTile`)
SCAN_TILE = 4096
#: epilogue op -> the kernel's op code
OPS = {"dot": 0, "cosine": 1, "euclidean": 2}
#: the cosine denominator's floor
EPS = 1e-30
#: least rows a call gathers (B*C*P*d*itemsize bytes) for which the kernel
#: sorts the pairs by block first; below, the pairs are scored in query
#: order.  The schedule costs 0.013 ms a call at 35k blocks, 0.030 ms at
#: 409,600 pairs over 236k.  On an NVIDIA H100 80GB HBM3 at 700 W
#: (`scripts/torch_gather_tune.py --crossover`, PERF.md), over the first B
#: = 1 .. 2048 queries of the probe slice's selections (bf16, int8, f32
#: rows, d 768) and the probe cell's (bf16, d 100): sorting lost in every
#: call of 312.5 MiB or less (by 2-33%) and won in every call of 432 MiB or
#: more (by 1.5-33%).
SCHEDULE_MIN_BYTES = 384 << 20
#: row dtype -> (the kernel's row_type code, launch counter name)
_ROW_TYPES = {
    torch.float32: (0, "gather_score_f32"),
    torch.bfloat16: (1, "gather_score_bf16"),
    torch.int8: (2, "gather_score_int8"),
}


@dataclass(frozen=True)
class Epilogue:
    """What the kernel writes in place of a row's dot: the probe's
    in-block score (`apply_epilogue`).

    op:    "dot", "cosine" or "euclidean" (the ranking form ``2·d − aux``,
           manhattan's too)
    aux:   [NBT, P] f32 per-slot term (‖x‖ for cosine, ‖x‖² for euclidean)
    slots: [NBT, P] int32 slots, -1 pad
    scale: [NBT, P] f32 int8 dequant scale, or None
    fmask: [cap] bool candidate mask over the slots, or None
    """

    op: str
    aux: torch.Tensor
    slots: torch.Tensor
    scale: torch.Tensor | None = None
    fmask: torch.Tensor | None = None


def apply_epilogue(d2: torch.Tensor, bid: torch.Tensor, ep: Epilogue) -> torch.Tensor:
    """The plain chain of the epilogue on the [B, C, P] dots of [B, C] ids
    (-1 pad): ``d2 · scale``, then the metric's op, each an f32 op of its
    own, and ``-inf`` where the id is -1, the slot is -1 or `fmask`
    excludes it."""
    safe = torch.clamp(bid, min=0).long()
    if ep.scale is not None:
        d2 = d2 * ep.scale[safe]  # dequant AFTER the dot
    if ep.op == "euclidean":
        s2 = 2.0 * d2 - ep.aux[safe]
    elif ep.op == "cosine":
        s2 = d2 / torch.clamp(ep.aux[safe], min=EPS)
    else:
        s2 = d2
    slot = torch.where((bid >= 0)[..., None], ep.slots[safe], -1)
    keep = slot >= 0
    if ep.fmask is not None:
        keep = keep & ep.fmask[torch.clamp(slot, min=0)]
    return torch.where(keep, s2, -float("inf"))


def gather_score_reference(blk_rows: torch.Tensor, bid: torch.Tensor, qv: torch.Tensor,
                           epilogue: Epilogue) -> torch.Tensor:
    """Plain PyTorch version: [NBT, P, d] rows, [B, C] ids (-1 pad),
    [B, d] f32 -> the [B, C, P] f32 scores of `epilogue`."""
    b, c = bid.shape
    _, p, d = blk_rows.shape
    ids = torch.clamp(bid, min=0)
    step = max(_REF_CHUNK_BYTES // max(b * p * d * 4, 1), 1)
    out = torch.empty((b, c, p), dtype=torch.float32, device=qv.device)
    for s in range(0, c, step):
        rows = blk_rows[ids[:, s : s + step].long()].float()
        out[:, s : s + step] = torch.einsum("bcpd,bd->bcp", rows, qv)
    return apply_epilogue(out, bid, epilogue)


def schedule_words(n: int, nbt: int) -> int:
    """int32 words of the kernel's schedule scratch for n pairs over nbt
    blocks: keys and pairs, the block counts (nbt + 1) and one sum a tile
    of `SCAN_TILE` counts."""
    return 2 * n + nbt + 1 + -(-(nbt + 1) // SCAN_TILE)


def block_schedule(bid: torch.Tensor, nbt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work order: the [B*C] block ids sorted and, beside each,
    the flat pair index b*C + c it came from, both int32, so the pairs that
    share a block are neighbours.  On the card this is the kernel's own
    schedule (a counting sort; the order of the pairs within a block may
    differ from run to run; ids outside [0, nbt) go last), on the CPU
    `torch.sort`."""
    flat = bid.reshape(-1)
    if flat.device.type == "cpu":
        keys, pairs = torch.sort(flat)
        return keys, pairs.to(torch.int32)
    n = flat.numel()
    scratch = torch.empty(schedule_words(n, nbt), dtype=torch.int32, device=flat.device)
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
        + [ctypes.c_int] + [ctypes.c_void_p] * 4
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


def work(blk_rows: torch.Tensor, bid: torch.Tensor, epilogue: Epilogue, chunks: int = 1) -> dict:
    """The work record of one call (`utils.profiling.counting`): B, C, P,
    d, the rows' type and element bytes, ``blocks``, the distinct block ids
    in [0, NBT) of `bid` (the blocks a call must read), ``chunks``, the
    calls its request's stage 2 was cut into, and ``epilogue``: the metric
    op, whether an int8 scale and a filter apply."""
    b, c = bid.shape
    nbt, p, d = blk_rows.shape
    ep = {"op": epilogue.op, "scale": epilogue.scale is not None,
          "filtered": epilogue.fmask is not None}
    return {"kernel": "gather_score", "B": b, "C": c, "P": p, "d": d,
            "dtype": str(blk_rows.dtype).removeprefix("torch."),
            "elem_bytes": blk_rows.element_size(),
            "blocks": int(torch.unique(bid[(bid >= 0) & (bid < nbt)]).numel()),
            "chunks": chunks, "epilogue": ep}


def _epilogue_args(ep: Epilogue, nbt: int, p: int, device) -> tuple:
    """The kernel's op code and epilogue pointers, after checking each
    tensor's type, shape (fmask: 1-D) and device."""
    if ep.op not in OPS:
        raise ValueError(f"gather_score: unknown epilogue op {ep.op!r}")
    ptrs = []
    for name, dtype, dims in (("aux", torch.float32, (nbt, p)), ("slots", torch.int32, (nbt, p)),
                              ("scale", torch.float32, (nbt, p)), ("fmask", torch.bool, None)):
        t = getattr(ep, name)
        if t is None and name in ("aux", "slots"):
            raise ValueError(f"gather_score: the epilogue needs {name}")
        if t is not None and (t.dtype != dtype or (tuple(t.shape) != dims if dims else t.dim() != 1)
                              or t.device != device or not t.is_contiguous()):
            raise ValueError(f"gather_score: epilogue {name} must be contiguous {dtype} "
                             f"{list(dims or ['cap'])} on {device}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
        ptrs.append(None if t is None else t.data_ptr())
    return (OPS[ep.op], *ptrs)


def gather_score(blk_rows: torch.Tensor, bid: torch.Tensor, qv: torch.Tensor,
                 epilogue: Epilogue, *, chunks: int = 1) -> torch.Tensor:
    """Score per-query selected blocks against the queries.

    blk_rows: [NBT, P, d] bf16 / f32 / int8 block tables
    bid:      [B, C] int32 block ids in [0, NBT), -1 pad
    qv:       [B, d] f32 queries
    epilogue: the scores to write (`Epilogue`)
    chunks:   the calls the request's stage 2 was cut into (work record only)
    returns:  [B, C, P] f32 scores of the dots ``q_b · row``
    """
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work(blk_rows, bid, epilogue, chunks))
    if blk_rows.device.type == "cpu":
        return gather_score_reference(blk_rows, bid, qv, epilogue)
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
    ep_args = _epilogue_args(epilogue, nbt, p, blk_rows.device)
    if b * c * p == 0:
        return torch.zeros((b, c, p), dtype=torch.float32, device=blk_rows.device)
    if d == 0:  # every dot is 0
        return apply_epilogue(torch.zeros((b, c, p), dtype=torch.float32, device=blk_rows.device),
                              bid, epilogue)
    if qv.data_ptr() % 16:  # the kernel reads the query in 16-byte vectors
        qv = qv.clone()
    out = torch.empty((b, c, p), dtype=torch.float32, device=blk_rows.device)
    row_type, name = _ROW_TYPES[blk_rows.dtype]
    scratch = None
    if b * c * p * d * blk_rows.element_size() >= SCHEDULE_MIN_BYTES:
        scratch = torch.empty(schedule_words(b * c, nbt), dtype=torch.int32,
                              device=blk_rows.device)
    with torch.cuda.device(blk_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().gather_score(row_type, _vec_bytes(blk_rows), blk_rows.data_ptr(),
                                 bid.data_ptr(), qv.data_ptr(), out.data_ptr(), b, c, p, d, nbt,
                                 stream, None if scratch is None else scratch.data_ptr(), *ep_args)
    _build.check(rc, name)
    launches[name] += 1
    return out
