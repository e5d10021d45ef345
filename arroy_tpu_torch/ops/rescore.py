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
the hand-written kernel (`csrc/rescore.cu`, one launch a batch, each
candidate row read once from the corpus) in the regime `_plan` picks from
(B, c, n2, d, k): a warp a query for c <= `WARP_MAX_C` (every shape the
main path sends), a CTA a query past it, or several CTAs a query where
few queries bring many candidates; or they raise.  On the CPU they run
`cut_rescore_reference` / `rescore_topk_reference`, the plain PyTorch
versions (a [B, c, d] f32 gather, elementwise distance, `torch.topk`).
Only the metrics whose distance the kernel computes are taken:
euclidean, cosine and dot-product.  Rows may be f32 or bf16 (promoted
exactly to f32).

The forest engines' exact re-scores (the probe's stage 3, the
traversal's `search._rescore_batch`; the JAX package's XLA code at
`arroy_tpu/probe.py:575-640` and `arroy_tpu/search.py:525-575`) dedup
their candidates as plain ops, then take `forest_rescore` where
`forest_kernel` says so: `rescore_topk` once a batch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import profiling
from . import _build
from .fused_select import DEAD_KEY_MAX

_INF = float("inf")

#: kernel launches on the card, per entry (test/smoke observability)
launches = {"cut_rescore": 0, "rescore_topk": 0}
#: the plan of each entry's last launch (`Plan`, None before the first)
last_plan = {"cut_rescore": None, "rescore_topk": None}
#: block regime: candidates a query keeps in the kernel's shared memory
#: (20 bytes each); a call with more gets a scratch buffer in device memory
SMEM_CANDIDATES = 2048
#: warp regime: the largest c (a warp sorts <= 512 composites in registers)
WARP_MAX_C = 512
#: warp regime: queries an SM at least (a warp each: fewer leave the SMs
#: idle, and a CTA a query is faster)
WARP_MIN_QUERIES = 7
#: warp regime: a query's shared bytes past its query row (slots, distance
#: keys, the select histogram: `kWarpExtra` in csrc/rescore.cu)
WARP_SMEM_EXTRA = 5120
#: warp regime: queries (warps) a CTA at most
WARP_QUERIES = 8
#: split regime: at least this many candidates and queries for at most
#: SPLIT_MAX_SHARE of the SMs; then S CTAs a query, enough for SPLIT_FILL
#: CTAs an SM
SPLIT_MAX_SHARE = 0.75
SPLIT_MIN_C = 2048
SPLIT_FILL = 2
#: split regime: columns a CTA re-scores at least
SPLIT_MIN_COLUMNS = 256
#: the largest dynamic shared memory a block may use (sm_90)
MAX_SMEM = 232_448
#: streaming multiprocessors of an H100 SXM (the plan's default)
H100_SMS = 132
#: the metrics the kernel computes -> its metric code
METRICS = {"euclidean": 0, "cosine": 1, "dot-product": 2}
REGIMES = {"warp": 0, "block": 1, "split": 2}
#: block regime: past this many queries an SM (more than one wave), its
#: registers are held to 4 CTAs an SM (more CTAs resident, fewer registers)
BLOCK_CAP_QUERIES = 2
_ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: candidates (B · c) one launch takes at most: the kernel indexes them in int32
MAX_CANDIDATES = 2**31 - 1


class Plan(NamedTuple):
    """How one call runs: `regime`, queries a CTA (`per_cta`, warp regime),
    CTAs a query (`splits`, split regime), CTAs in all (`grid`), scratch
    bytes a query (`stride`, 0 for none), whether it takes tickets, and
    (block regime) whether its registers are held to 4 CTAs an SM."""

    regime: str
    per_cta: int
    splits: int
    grid: int
    stride: int
    tickets: bool
    capped: bool = False

    @property
    def code(self) -> int:
        """The C entries' regime argument."""
        return 3 if self.capped else REGIMES[self.regime]


def _plans(b: int, c: int, n2: int | None, d: int, k: int, sms: int = H100_SMS) -> dict:
    """Every plan that can run a call with B = `b` queries, `c` candidates
    each (cut from `n2` keys, or a list where `n2` is None), rows of `d`
    and top `k`, by name: "warp" (c <= WARP_MAX_C and a query's row fits a
    CTA's shared memory: a warp a query, up to WARP_QUERIES a CTA),
    "block" and "block capped" (a CTA a query, with 20 · c bytes of
    scratch a query, 16-byte aligned, past SMEM_CANDIDATES; capped: its
    registers held to 4 CTAs an SM), and "split" (S CTAs a query, enough
    for SPLIT_FILL an SM, each with SPLIT_MIN_COLUMNS columns or more, of
    the c candidates or the n2 positions, and a scratch of 8 · (W + k)
    bytes a query, W = c or n2; where S >= 2).  `_plan` picks one; the
    A/B script and the card's tests force the others."""
    plans = {}
    per_warp = -(-d * 4 // 16) * 16 + WARP_SMEM_EXTRA
    if c <= WARP_MAX_C and per_warp <= MAX_SMEM:
        q = min(WARP_QUERIES, MAX_SMEM // per_warp)
        plans["warp"] = Plan("warp", q, 1, -(-b // q), 0, False)
    stride = 0 if c <= SMEM_CANDIDATES else -(-20 * c // 16) * 16
    plans["block"] = Plan("block", 1, 1, b, stride, False)
    plans["block capped"] = plans["block"]._replace(capped=True)
    width = c if n2 is None else n2
    s = min(-(-SPLIT_FILL * sms // max(b, 1)), -(-width // SPLIT_MIN_COLUMNS))
    if s > 1:
        plans["split"] = Plan("split", 1, s, b * s, 8 * (width + k), True)
    return plans


def _plan(b: int, c: int, n2: int | None, d: int, k: int, sms: int = H100_SMS) -> Plan:
    """The plan of a call (`_plans`' arguments): warp from WARP_MIN_QUERIES
    queries an SM; else split for c >= SPLIT_MIN_C and b <= SPLIT_MAX_SHARE
    · sms (a CTA a query would leave SMs idle); else block, its registers
    capped past BLOCK_CAP_QUERIES queries an SM."""
    plans = _plans(b, c, n2, d, k, sms)
    if "warp" in plans and b >= WARP_MIN_QUERIES * sms:
        return plans["warp"]
    if "split" in plans and c >= SPLIT_MIN_C and b <= SPLIT_MAX_SHARE * sms:
        return plans["split"]
    return plans["block capped" if b > BLOCK_CAP_QUERIES * sms else "block"]


_sms: dict = {}


def _sm_count(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


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


def key_cut(c, keys, idxp, pos_to_slot, live):
    """The top ``c`` of kernel 1's keys as candidates: [B, c] slots and
    their validity (`torch.topk` over the keys)."""
    selk, sel = torch.topk(keys, min(c, keys.shape[1]), dim=1)
    cand = pos_to_slot[torch.gather(idxp, 1, sel).long()]
    # keys at/below DEAD_KEY_MAX mark padding/dead positions (which alias
    # slot 0 through pos_to_slot — key-masking also prevents duplicate ids)
    return cand, live[cand] & (selk > DEAD_KEY_MAX)


def cut_rescore_reference(
    metric, dims, k, c, keys, idxp, pos_to_slot, live, rows, norms, extras, slot_to_id,
    qv, qn, qe, normalize=True,
):
    """Plain version of `cut_rescore`: `key_cut`, then
    `rescore_topk_reference`."""
    cand, valid = key_cut(c, keys, idxp, pos_to_slot, live)
    return rescore_topk_reference(
        metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize
    )


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib():
    return _bind(_build.load("rescore"))


def _bind(lib):
    """Set the C entries' types on a loaded `csrc/rescore.cu` library."""
    lib.cut_rescore.restype = ctypes.c_int
    lib.cut_rescore.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    lib.rescore_topk.restype = ctypes.c_int
    lib.rescore_topk.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    return lib


def _common(what, metric, k, c, n2, rows, norms, slot_to_id, qv, qn, tensors):
    """Check what both entries take; returns (metric code, row type, vec,
    outputs, the plan, and its scratch and tickets, or None)."""
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
    if cap > MAX_CANDIDATES or b * c > MAX_CANDIDATES:
        raise ValueError(f"{what}: {cap} rows and {b} x {c} candidates must stay under 2^31")
    tensors = (rows, norms, slot_to_id, qv, qn) + tensors
    if any(t.device != rows.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous on one device")
    plan = _plan(b, c, n2, d, k, _sm_count(rows.device))
    scratch = tickets = None
    if plan.stride:
        scratch = torch.empty(b * plan.stride, dtype=torch.uint8, device=rows.device)
    if plan.tickets:
        tickets = torch.zeros(b, dtype=torch.int32, device=rows.device)
    es = rows.element_size()
    vec = int((d * es) % 16 == 0 and rows.data_ptr() % 16 == 0)
    ids = torch.empty((b, k), dtype=torch.int64, device=rows.device)
    out = torch.empty((b, k), dtype=torch.float32, device=rows.device)
    return METRICS[metric.name], _ROW_TYPES[rows.dtype], vec, ids, out, plan, scratch, tickets


def _ptr(t):
    return None if t is None else t.data_ptr()


def work(entry, k, cand, valid, rows, n2=None) -> dict:
    """The work record of one call (`utils.profiling.counting`): the
    entry, B, c (candidates a query), n2 (the keys a query brings to the
    cut; None for a list), d, k, the rows' type and element bytes, the
    valid candidates, and ``rows``, the distinct slots among them: the
    rows a call must read."""
    b, c = cand.shape
    return {"kernel": entry, "B": b, "c": c, "n2": n2, "d": rows.shape[1], "k": k,
            "dtype": str(rows.dtype).removeprefix("torch."), "elem_bytes": rows.element_size(),
            "valid": int(valid.sum()), "rows": int(torch.unique(cand[valid]).numel())}


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
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work("cut_rescore", k, *key_cut(c, keys, idxp, pos_to_slot, live), rows,
                         keys.shape[1]))
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
    code, row_type, vec, ids, out, plan, scratch, tickets = _common(
        "cut_rescore", metric, k, cw, n2, rows, norms, slot_to_id, qv, qn,
        (keys, idxp, pos_to_slot, live))
    if b == 0:
        return ids, out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cut_rescore(
            code, row_type, vec, rows.data_ptr(), norms.data_ptr(), slot_to_id.data_ptr(),
            qv.data_ptr(), qn.data_ptr(), keys.data_ptr(), idxp.data_ptr(),
            pos_to_slot.data_ptr(), live.data_ptr(), ids.data_ptr(), out.data_ptr(),
            _ptr(scratch), _ptr(tickets), plan.stride, b, rows.shape[1], n2, cw, k,
            int(normalize), plan.code, plan.per_cta, plan.splits, stream)
    _build.check(rc, "cut_rescore")
    launches["cut_rescore"] += 1
    last_plan["cut_rescore"] = plan
    return ids, out


def rescore_topk(
    metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize=True
):
    """Re-score a [B, c] candidate slot list exactly and return the top-k.

    cand:  [B, c] int64 slots (each in [0, cap)); valid [B, c] bool
    rows:  [cap, d] f32 or bf16; norms [cap] f32; slot_to_id [cap] int64
    qv [B, d], qn [B] f32 (``extras``, ``qe``: the plain version's only)

    Returns (ids [B, k] int64, d [B, k] f32) as `cut_rescore` does."""
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work("rescore_topk", k, cand, valid, rows))
    if rows.device.type == "cpu":
        return rescore_topk_reference(metric, dims, k, cand, valid, rows, norms, extras,
                                      slot_to_id, qv, qn, qe, normalize)
    b, c = cand.shape
    if cand.dtype != torch.int64 or valid.dtype != torch.bool or valid.shape != cand.shape:
        raise TypeError("rescore_topk: cand must be int64 and valid bool, of one shape")
    if b != qv.shape[0]:
        raise ValueError(f"rescore_topk: {b} candidate rows for {qv.shape[0]} queries")
    code, row_type, vec, ids, out, plan, scratch, tickets = _common(
        "rescore_topk", metric, k, c, None, rows, norms, slot_to_id, qv, qn, (cand, valid))
    if b == 0:
        return ids, out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().rescore_topk(
            code, row_type, vec, rows.data_ptr(), norms.data_ptr(), slot_to_id.data_ptr(),
            qv.data_ptr(), qn.data_ptr(), cand.data_ptr(), valid.data_ptr(), ids.data_ptr(),
            out.data_ptr(), _ptr(scratch), _ptr(tickets), plan.stride, b, rows.shape[1], c, k,
            int(normalize), plan.code, plan.per_cta, plan.splits, stream)
    _build.check(rc, "rescore_topk")
    launches["rescore_topk"] += 1
    last_plan["rescore_topk"] = plan
    return ids, out


# ---------------------------------------------------------------------------
# the forest engines' re-scores
# ---------------------------------------------------------------------------


def forest_kernel(metric, device) -> bool:
    """Whether a forest engine's exact re-score (the probe's stage 3,
    `search._rescore_batch`) runs on the kernel: tensors on a CUDA device
    and a metric it computes.  Manhattan, the BQ metrics and registered
    metrics keep their caller's plain chain on every device, and so does
    every metric on the CPU (the callers' chains gather in chunks, where
    `rescore_topk_reference` gathers [B, c, d] whole)."""
    return torch.device(device).type == "cuda" and metric.name in METRICS


def forest_rescore(
    metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe, normalize=True
):
    """`rescore_topk` over a forest engine's deduplicated [B, c] candidate
    list: one launch a batch, or one a chunk of queries where B · c passes
    `MAX_CANDIDATES` (a filter pool of 2^20 slots at B = 2048)."""
    qv, qn = qv.contiguous(), qn.contiguous()
    step = max(1, MAX_CANDIDATES // max(cand.shape[1], 1))
    if cand.shape[0] <= step:
        return rescore_topk(metric, dims, k, cand, valid, rows, norms, extras, slot_to_id,
                            qv, qn, qe, normalize)
    parts = [
        rescore_topk(metric, dims, k, cand[s:s + step], valid[s:s + step], rows, norms, extras,
                     slot_to_id, qv[s:s + step], qn[s:s + step], qe[s:s + step], normalize)
        for s in range(0, cand.shape[0], step)
    ]
    return torch.cat([i for i, _ in parts]), torch.cat([d for _, d in parts])
