"""Kernel 6: the leaf probe's stage 1 (centroid product, affine, valid
mask, per-tree top-L) in one hand-written kernel.

For queries ``qcent`` [B, d] f32 and T probe trees of ``nb_max`` blocks
each (``cent`` [T·nb_max, d] f32 centroids, ``caux`` [T·nb_max] f32,
``valid`` [T·nb_max] bool)::

    score[b, t, j] = scale · qcent[b] · cent[t·nb_max + j] − caux[t·nb_max + j]
                     (−inf where not valid)

and the result is the [B, T·L] int64 ids ``t·nb_max + j`` of each
(query, tree)'s L best blocks, in descending score, equal scores by the
lower j: what `rank_blocks_reference` (the f32 GEMM with TF32 off, the
affine, `torch.where` and `torch.topk`) returns, up to the summation
order of the dots.  The JAX package leaves this stage to XLA
(`arroy_tpu/probe.py` `_rank_blocks`); it has no Pallas kernel.

`rank_blocks`, the one entry, routes by where the tensors live and by
the shape: on a CUDA device, where `uses_kernel` holds (L <= `MAX_L` and
B at or past the crossover `min_queries` measured for the table's size,
d and L), it launches the kernel (`csrc/rank_select.cu`: a register-tiled
f32 product whose epilogue keeps each query's running top-L, so the
[B, T·nb_max] scores are never written; then a merge of the column
ranges); elsewhere on the card (fewer queries, a larger L, as a
selective filter makes, a wider d or a smaller table) it runs the plain
chain and counts the call in `plain_calls`; on the CPU it runs the plain
chain.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

#: kernel launches on the card (a call is one scan and one merge launch)
launches = {"rank_select": 0}
#: stage-1 calls on a CUDA device that took the plain chain (`uses_kernel`)
plain_calls = {"rank_blocks": 0}
#: the largest L the route sends to the kernel.  The kernel keeps up to 128
#: (`kMaxL` in the source: a CTA holds L keys for each of its 128 queries
#: in shared memory), but past 64 it needed 1,024 queries or more to beat
#: the plain chain on 4 × 8,192 blocks (`CROSSOVER`'s measurements) and
#: was not measured on smaller tables.  L is search_k over T·P·fill
#: real slots (`probe.blocks_per_tree`): 25 at the probe cell's search_k
#: 8000 (T = 8, P = 64), so 64 covers its unfiltered probe up to search_k
#: ≈ 20,000.
MAX_L = 64
#: the route rule's crossovers: (fewest blocks T·nb_max, widest d) → the
#: fewest queries from which kernel 6 was faster than the plain chain at
#: every larger batch measured, for L <= each of `CROSSOVER_L`.  A CTA
#: scores 128 queries whatever B is, while the plain chain's product and
#: passes shrink with B; and each column range first fills its queries'
#: heaps of L keys, which small tables (few 128-block tiles a range) and
#: a large L do not amortize.  Measured on random tables of 8 × 1,100 to
#: 8 × 23,100 blocks, d = 100 to 1,536, L = 5 to 128, B = 16 to 2,048, the
#: kernel and the plain chain in turns (`scripts/torch_rank_select_ab.py
#: --sweep`; NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6).  A shape with
#: fewer blocks, a wider d or a larger L than any entry takes the plain
#: chain; one between entries takes the next stricter one.
CROSSOVER_L = (9, 25, 64)
CROSSOVER = {
    (8_800, 100): (64, 128, 512),
    (8_800, 768): (128, 512, 1024),
    (32_768, 100): (40, 64, 256),
    (32_768, 768): (128, 256, 512),
}


def rank_blocks_reference(qcent, cent, caux, valid, scale, L: int, nb_max: int) -> torch.Tensor:
    """The plain chain: an f32 GEMM (TF32 off), the affine, the valid mask
    and a per-tree `torch.topk` → [B, T·L] int64 block ids."""
    from ..search import _f32_matmul

    b = qcent.shape[0]
    T = cent.shape[0] // nb_max
    score = float(scale) * _f32_matmul(qcent, cent) - caux[None, :]
    score = torch.where(valid[None, :], score, -float("inf"))
    topL = torch.topk(score.reshape(b, T, nb_max), L, dim=2).indices  # [B, T, L]
    base = (torch.arange(T, device=qcent.device) * nb_max)[None, :, None]
    return (topL + base).reshape(b, T * L)


def min_queries(blocks: int, d: int, L: int) -> int | None:
    """The fewest queries the route sends to the kernel for a table of
    ``blocks`` (T·nb_max) centroids of width ``d`` and L blocks a tree
    (`CROSSOVER`); None where it sends none."""
    if L > MAX_L:
        return None
    col = next(i for i, top in enumerate(CROSSOVER_L) if L <= top)
    fits = [(n, w) for n, w in CROSSOVER if blocks >= n and d <= w]
    if not fits:
        return None
    n = max(n for n, _ in fits)
    w = min(w for m, w in fits if m == n)
    return CROSSOVER[n, w][col]


def uses_kernel(b: int, L: int, d: int, blocks: int, device) -> bool:
    """The route rule: the kernel on a CUDA device from `min_queries`
    queries on, else the plain chain."""
    least = min_queries(blocks, d, L)
    return torch.device(device).type == "cuda" and least is not None and b >= least


def work(qcent, cent, L: int, nb_max: int, route: str) -> dict:
    """The work record of one call (`utils.profiling.counting`): B, T,
    nb_max, L, d and the route taken ("kernel" or "plain")."""
    return {"kernel": "rank_select", "B": qcent.shape[0], "T": cent.shape[0] // max(nb_max, 1),
            "nb_max": nb_max, "L": L, "d": cent.shape[1], "route": route}


def _check(qcent, cent, caux, valid, L: int, nb_max: int) -> None:
    tensors = (qcent, cent, caux, valid)
    if any(t.dtype != torch.float32 for t in (qcent, cent, caux)) or valid.dtype != torch.bool:
        raise TypeError("rank_select: qcent, cent and caux must be float32 and valid bool")
    if qcent.dim() != 2 or cent.dim() != 2 or caux.dim() != 1 or valid.dim() != 1:
        raise ValueError("rank_select: expected qcent [B, d], cent [N, d], caux [N], valid [N]")
    n, d = cent.shape
    if (qcent.shape[1] != d or caux.shape[0] != n or valid.shape[0] != n or nb_max < 1
            or n % nb_max):
        raise ValueError(
            f"rank_select: bad shapes qcent{tuple(qcent.shape)} cent{tuple(cent.shape)} "
            f"caux{tuple(caux.shape)} valid{tuple(valid.shape)} for nb_max {nb_max}")
    if not 1 <= L <= nb_max:
        raise ValueError(f"rank_select: L = {L} must be in [1, {nb_max}] (the blocks of a tree)")
    if any(t.device != cent.device or not t.is_contiguous() for t in tensors):
        raise ValueError("rank_select: tensors must be contiguous on one device")


def _lib():
    lib = _build.load("rank_select")
    lib.rank_select.restype = ctypes.c_int
    lib.rank_select.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    )
    lib.rank_select_splits.restype = ctypes.c_int
    lib.rank_select_splits.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def _launch(qcent, cent, caux, valid, scale, L: int, nb_max: int) -> torch.Tensor:
    """The kernel: a scan over S column ranges a tree (the library's plan
    for this card and L), then a merge of the ranges' lists."""
    b, d = qcent.shape
    T = cent.shape[0] // nb_max
    out = torch.empty((b, T * L), dtype=torch.int64, device=cent.device)
    if b == 0:
        return out
    lib = _lib()
    splits = ctypes.c_int(0)
    with torch.cuda.device(cent.device):
        _build.check(lib.rank_select_splits(b, T, nb_max, L, ctypes.byref(splits)),
                     "rank_select_splits")
        part = torch.empty(b * T * splits.value * L, dtype=torch.int64, device=cent.device)
        rc = lib.rank_select(
            qcent.data_ptr(), cent.data_ptr(), caux.data_ptr(), valid.data_ptr(), float(scale),
            b, d, T, nb_max, L, splits.value, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "rank_select")
    launches["rank_select"] += 1
    return out


def rank_blocks(qcent, cent, caux, valid, scale, L: int, nb_max: int) -> torch.Tensor:
    """Stage 1 of the probe: [B, d] f32 queries (binary metrics decoded to
    ±1), [T·nb_max, d] f32 centroids, [T·nb_max] caux and valid, the
    metric's ``scale`` (1 or 2) → [B, T·L] int64 block ids, each tree's L
    best in descending score (see the module's docstring for the route)."""
    L, nb_max = int(L), int(nb_max)
    _check(qcent, cent, caux, valid, L, nb_max)
    kernel = uses_kernel(qcent.shape[0], L, qcent.shape[1], cent.shape[0], cent.device)
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work(qcent, cent, L, nb_max, "kernel" if kernel else "plain"))
    if kernel:
        return _launch(qcent, cent, caux, valid, scale, L, nb_max)
    if cent.device.type == "cuda":
        plain_calls["rank_blocks"] += 1
    elif cent.device.type != "cpu":
        raise ValueError(f"rank_select: unsupported device {cent.device}")
    return rank_blocks_reference(qcent, cent, caux, valid, scale, L, nb_max)
