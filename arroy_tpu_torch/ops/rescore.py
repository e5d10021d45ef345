"""Kernel 5: the exact engine's stage 2 (key cut, candidate gather, exact
f32 re-score, top-k).

Counterpart of what XLA fuses into one program at the end of the JAX
package's exact searches (`arroy_tpu/search.py:1702-1719` in
`_exact_fused_impl`, and the re-score tails of `_exact_f32_direct_impl`,
`_exact_f32_impl` and `_exact_scan_impl`); the JAX package has no Pallas
kernel for it.  Two entries:

* `cut_rescore` — kernel 1's packed keys and positions [B, 2nb] → the
  top ``c`` keys → candidate slots (``pos_to_slot``), valid where the key
  is above `DEAD_KEY_MAX` and the slot is live → re-score → top-k;
* `rescore_topk` — a [B, c] candidate slot list and its validity mask →
  re-score → top-k.

Both dispatch on where their tensors live: on a CUDA device they launch
the hand-written kernel (`csrc/rescore.cu`: a CTA a query, a radix select
for the cut, each candidate row read once from the corpus, a radix sort
for the top-k, one launch a batch) or raise; on the CPU they run
`cut_rescore_reference` / `rescore_topk_reference`, the plain PyTorch
versions (a [B, c, d] f32 gather, elementwise distance, `torch.topk`).
Only the metrics whose distance the kernel computes are taken:
euclidean, cosine and dot-product.  Rows may be f32 or bf16 (promoted
exactly to f32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_select import DEAD_KEY_MAX

_INF = float("inf")

#: kernel launches on the card, per entry (test/smoke observability)
launches = {"cut_rescore": 0, "rescore_topk": 0}
#: candidates a query keeps in the kernel's shared memory (20 bytes each);
#: a call with more gets a [B, 5c] int32 scratch buffer in device memory
SMEM_CANDIDATES = 2048
#: the metrics the kernel computes -> its metric code
METRICS = {"euclidean": 0, "cosine": 1, "dot-product": 2}
_ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def rescore_distances(metric, qv, qn, qe, cand, rows, norms, extras, valid):
    """Exact per-pair distances of the [B, c] candidate slots (inf where
    not `valid`)."""
    d = metric.built_distance(
        qv[:, None, :], qn[:, None], qe[:, None], rows[cand], norms[cand], extras[cand]
    )
    return torch.where(valid, d, _INF)


def finish_topk(metric, dims, k, d, slot_to_id, cand=None, normalize=True):
    """Top-k smallest of [B, n] distances → (ids [B, k], normalized d).
    Column j is slot ``cand[:, j]``, or slot j when `cand` is None.  With
    ``normalize=False`` the distances stay raw, +inf where dead (what a
    sharded index merges)."""
    out_d, top = torch.topk(d, k, dim=1, largest=False)
    ids = slot_to_id[top if cand is None else torch.gather(cand, 1, top)]
    if not normalize:
        return ids, out_d
    out_d = torch.where(
        out_d < _INF, metric.normalized_distance(out_d, dims), float("nan")
    )
    return ids, out_d


def rescore_topk_reference(
    metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize=True
):
    """Plain version of `rescore_topk`: gather, distance, `torch.topk`."""
    d = rescore_distances(metric, qv, qn, qe, cand, rows, norms, extras, valid)
    return finish_topk(metric, dims, k, d, slot_to_id, cand, normalize)


def cut_rescore_reference(
    metric, dims, k, c, keys, idxp, pos_to_slot, live, rows, norms, extras, slot_to_id,
    qv, qn, qe, normalize=True,
):
    """Plain version of `cut_rescore`: `torch.topk` over the keys, then
    `rescore_topk_reference`."""
    cw = min(c, keys.shape[1])
    selk, sel = torch.topk(keys, cw, dim=1)
    cand = pos_to_slot[torch.gather(idxp, 1, sel).long()]
    # keys at/below DEAD_KEY_MAX mark padding/dead positions (which alias
    # slot 0 through pos_to_slot — key-masking also prevents duplicate ids)
    valid = live[cand] & (selk > DEAD_KEY_MAX)
    return rescore_topk_reference(
        metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize
    )


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("rescore")
    lib.cut_rescore.restype = ctypes.c_int
    lib.cut_rescore.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.rescore_topk.restype = ctypes.c_int
    lib.rescore_topk.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    return lib


def _common(what, metric, k, c, rows, norms, slot_to_id, qv, qn, tensors):
    """Check what both entries take; returns (metric code, row type, vec,
    outputs, scratch)."""
    if rows.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rows.device}")
    if metric.name not in METRICS:
        raise ValueError(f"{what}: no kernel for metric {metric.name!r}")
    if rows.dtype not in _ROW_TYPES:
        raise TypeError(f"{what}: rows must be f32 or bf16, got {rows.dtype}")
    if any(t.dtype != torch.float32 for t in (norms, qv, qn)) or slot_to_id.dtype != torch.int64:
        raise TypeError(f"{what}: norms, qv and qn must be float32 and slot_to_id int64")
    cap, d = rows.shape
    b = qv.shape[0]
    if (qv.shape != (b, d) or qn.shape != (b,) or norms.shape != (cap,)
            or slot_to_id.shape != (cap,)):
        raise ValueError(
            f"{what}: bad shapes rows{tuple(rows.shape)} norms{tuple(norms.shape)} "
            f"slot_to_id{tuple(slot_to_id.shape)} qv{tuple(qv.shape)} qn{tuple(qn.shape)}"
        )
    if not 1 <= k <= c:
        raise ValueError(f"{what}: k = {k} must be in [1, {c}] (the candidates a query has)")
    if cap >= 2**31 or b * c >= 2**31:
        raise ValueError(f"{what}: {cap} rows and {b} x {c} candidates must stay under 2^31")
    tensors = (rows, norms, slot_to_id, qv, qn) + tensors
    if any(t.device != rows.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous on one device")
    scratch = None
    if c > SMEM_CANDIDATES:
        scratch = torch.empty((b, 5 * c), dtype=torch.int32, device=rows.device)
    es = rows.element_size()
    vec = int((d * es) % 16 == 0 and rows.data_ptr() % 16 == 0)
    ids = torch.empty((b, k), dtype=torch.int64, device=rows.device)
    out = torch.empty((b, k), dtype=torch.float32, device=rows.device)
    return METRICS[metric.name], _ROW_TYPES[rows.dtype], vec, ids, out, scratch


def cut_rescore(
    metric, dims, k, c, keys, idxp, pos_to_slot, live, rows, norms, extras, slot_to_id,
    qv, qn, qe, normalize=True,
):
    """Stage 2 of the fused route: cut kernel 1's keys to ``c`` candidates,
    re-score them exactly, return the top-k.

    keys, idxp:  [B, n2] int32 packed keys and table positions (kernel 1)
    pos_to_slot: [Mp] int64 table position -> slot
    live:        [cap] bool
    rows:        [cap, d] f32 or bf16; norms [cap] f32; slot_to_id [cap] int64
    qv [B, d], qn [B] f32 (``extras``, ``qe``: the plain version's only)

    Returns (ids [B, k] int64, d [B, k] f32), ascending; normalized with
    NaN where fewer than k candidates are valid, or raw (+inf) with
    ``normalize=False``."""
    if rows.device.type == "cpu":
        return cut_rescore_reference(metric, dims, k, c, keys, idxp, pos_to_slot, live, rows,
                                     norms, extras, slot_to_id, qv, qn, qe, normalize)
    b, n2 = keys.shape
    cw = min(c, n2)
    if keys.dtype != torch.int32 or idxp.dtype != torch.int32 or idxp.shape != keys.shape:
        raise TypeError("cut_rescore: keys and idxp must be int32 of one shape")
    if pos_to_slot.dtype != torch.int64 or live.dtype != torch.bool or live.shape != rows.shape[:1]:
        raise TypeError("cut_rescore: pos_to_slot must be int64 and live bool [cap]")
    if b != qv.shape[0]:
        raise ValueError(f"cut_rescore: {b} key rows for {qv.shape[0]} queries")
    code, row_type, vec, ids, out, scratch = _common(
        "cut_rescore", metric, k, cw, rows, norms, slot_to_id, qv, qn,
        (keys, idxp, pos_to_slot, live))
    if b == 0:
        return ids, out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cut_rescore(
            code, row_type, vec, rows.data_ptr(), norms.data_ptr(), slot_to_id.data_ptr(),
            qv.data_ptr(), qn.data_ptr(), keys.data_ptr(), idxp.data_ptr(),
            pos_to_slot.data_ptr(), live.data_ptr(), ids.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, rows.shape[1], n2, cw, k,
            int(normalize), stream)
    _build.check(rc, "cut_rescore")
    launches["cut_rescore"] += 1
    return ids, out


def rescore_topk(
    metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize=True
):
    """Re-score a [B, c] candidate slot list exactly and return the top-k.

    cand:  [B, c] int64 slots (each in [0, cap)); valid [B, c] bool
    rows:  [cap, d] f32 or bf16; norms [cap] f32; slot_to_id [cap] int64
    qv [B, d], qn [B] f32 (``extras``, ``qe``: the plain version's only)

    Returns (ids [B, k] int64, d [B, k] f32) as `cut_rescore` does."""
    if rows.device.type == "cpu":
        return rescore_topk_reference(metric, dims, k, cand, valid, rows, norms, extras,
                                      slot_to_id, qv, qn, qe, normalize)
    b, c = cand.shape
    if cand.dtype != torch.int64 or valid.dtype != torch.bool or valid.shape != cand.shape:
        raise TypeError("rescore_topk: cand must be int64 and valid bool, of one shape")
    if b != qv.shape[0]:
        raise ValueError(f"rescore_topk: {b} candidate rows for {qv.shape[0]} queries")
    code, row_type, vec, ids, out, scratch = _common(
        "rescore_topk", metric, k, c, rows, norms, slot_to_id, qv, qn, (cand, valid))
    if b == 0:
        return ids, out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().rescore_topk(
            code, row_type, vec, rows.data_ptr(), norms.data_ptr(), slot_to_id.data_ptr(),
            qv.data_ptr(), qn.data_ptr(), cand.data_ptr(), valid.data_ptr(), ids.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, rows.shape[1],
            c, k, int(normalize), stream)
    _build.check(rc, "rescore_topk")
    launches["rescore_topk"] += 1
    return ids, out
