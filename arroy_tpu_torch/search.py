"""The serving engines: exact (brute force) and the forest dispatch.

Counterpart of `arroy_tpu/search.py`: `make_exact_fn`, `exact_batch`
and their stage functions, and of the forest engine `make_search_fn`
up to its probe dispatch (the empty index, the filter-pool shortcut with
its re-score family, and the leaf-probe engine of `probe.py`); the
best-first traversal raises `NotImplementedError`.

The exact engine's modes score every live
item of the corpus and returns the top-k under the reference's exact
distance formulas:

* ``f32x1`` — f32 matmul distances, a top-4k cut, exact re-score;
* ``f32`` — f32 matmul scores, a top-c cut, exact re-score;
* ``int8`` / ``bf16`` (``auto`` = bf16) — stage 1 is the fused select
  kernel (`ops/fused_select`), which keeps each 256-row block's best two
  packed keys without materializing [B, M]; stage 2 cuts those to ``c``
  candidates and re-scores them exactly in f32 (the oversample + exact
  re-score contract, reference src/reader.rs:381-401).  Corpora too
  small for the per-block top-2 to hold ``max(k, 32)`` candidates serve
  the unfused two-stage path (quantized dots, an exact f32 top-c cut,
  the same re-score);
* binary-quantized metrics — the popcount distance matrix kernel
  (`ops/bq_kernels`), exact integer distances;
* manhattan — the per-pair formula over every row.

Cuts use exact `torch.topk` (the JAX package's `approx_max_k` has no
counterpart; an exact cut can only raise recall).  Tie order among equal
distances is unspecified, as with any top-k on the GPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import DeviceIndex
from .ops.bq_kernels import bq_hamming_matrix
from .ops.binary import WORD_BITS
from .ops.fused_select import DEAD_KEY_MAX, DEFAULT_BM, DEFAULT_GP, fused_block_select

_INF = float("inf")
_F32_EPS = float(np.finfo(np.float32).eps)
#: the [B, M] score matrix budget; past it the JAX package streams item
#: chunks (`_exact_scan_impl`, `_exact_bq_scan_impl`), not yet ported
_EXACT_DOTS_BYTES = 4 << 30
#: largest fused-select corpus table (int8/bf16 rows) built at bind time
_FUSED_TABLE_BYTES = 3 << 30
#: bytes of one [Bc, M, sd] temporary in the per-pair formula path
_PAIR_CHUNK_BYTES = 256 << 20

_SCAN_TODO = (
    "the [B, M] score matrix exceeds its budget; the streaming exact scans "
    "are not ported yet (ROADMAP queue 1: streaming scans)"
)


def _next_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _row_sq(rows: torch.Tensor) -> torch.Tensor:
    r = rows.float()
    return torch.sum(r * r, dim=1)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in full f32: TF32 would keep ~3 digits of each product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b.T


def _check_dots_budget(b: int, cap: int) -> None:
    if b * cap * 4 > _EXACT_DOTS_BYTES:
        raise NotImplementedError(_SCAN_TODO)


def _rescore(metric, qv, qn, qe, cand, rows, norms, extras, valid):
    """Exact per-pair distances of the [B, c] candidate slots (inf where
    not `valid`)."""
    d = metric.built_distance(
        qv[:, None, :], qn[:, None], qe[:, None], rows[cand], norms[cand], extras[cand]
    )
    return torch.where(valid, d, _INF)


def _finish(metric, dims, k, d, slot_to_id, cand=None):
    """Top-k smallest of [B, n] distances → (ids [B, k], normalized d).
    Column j is slot ``cand[:, j]``, or slot j when `cand` is None."""
    out_d, top = torch.topk(d, k, dim=1, largest=False)
    ids = slot_to_id[top if cand is None else torch.gather(cand, 1, top)]
    out_d = torch.where(
        out_d < _INF, metric.normalized_distance(out_d, dims), float("nan")
    )
    return ids, out_d


# ---------------------------------------------------------------------------
# stage functions (one per JAX `_exact_*_impl`)
# ---------------------------------------------------------------------------


def _exact_f32_direct(metric, dims, k, x2, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """f32 matmul distances + top-4k cut + exact re-score (`_exact_f32_direct_impl`)."""
    dots = _f32_matmul(qv, rows)
    if metric.name == "euclidean":
        q2 = torch.sum(qv * qv, dim=1)
        d = torch.clamp(x2[None, :] - 2.0 * dots + q2[:, None], min=0.0)
    elif metric.name == "cosine":
        pnqn = norms[None, :] * qn[:, None]
        ok = pnqn > _F32_EPS
        cos = torch.clamp(dots / torch.where(ok, pnqn, 1.0), -1.0, 1.0)
        d = torch.where(ok, (1.0 - cos) / 2.0, 0.0)
    else:  # dot-product
        d = -dots
    d = torch.where(live[None, :], d, _INF)
    k2 = min(max(4 * k, 32), rows.shape[0])
    d2, cand = torch.topk(d, k2, dim=1, largest=False)
    dr = _rescore(metric, qv, qn, qe, cand, rows, norms, extras, d2 < _INF)
    return _finish(metric, dims, k, dr, slot_to_id, cand)


def _score(metric, dots, x2, norms):
    """argmax-ordered stage-1 score from dots (euclidean: 2q·x - |x|²)."""
    if metric.name == "euclidean":
        return 2.0 * dots - x2[None, :]
    if metric.name == "cosine":
        return dots / torch.where(norms > 0.0, norms, 1.0)[None, :]
    return dots  # dot-product: the query's extra coordinate is 0


def _two_stage(metric, dims, k, c, score, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """Exact f32 top-c cut of an f32 score matrix, then exact re-score."""
    score = torch.where(live[None, :], score, -_INF)
    sc, cand = torch.topk(score, c, dim=1)
    valid = live[cand] & (sc > -_INF)
    d = _rescore(metric, qv, qn, qe, cand, rows, norms, extras, valid)
    return _finish(metric, dims, k, d, slot_to_id, cand)


def _exact_fused(metric, dims, k, c, int8, tables, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """Fused-select stage 1 + key cut + exact re-score (`_exact_fused_impl`)."""
    xq, mult, add, pos_to_slot = tables
    d_pad = xq.shape[1]
    if int8:
        qmax = torch.amax(torch.abs(qv), dim=1)
        qsc = torch.where(qmax > 0, qmax / 127.0, 1.0)
        q = torch.clamp(torch.round(qv / qsc[:, None]), -127, 127).to(torch.int8)
    else:
        qsc = torch.ones(qv.shape[0], dtype=torch.float32, device=qv.device)
        q = qv.to(torch.bfloat16)
    if d_pad != q.shape[1]:
        q = torch.nn.functional.pad(q, (0, d_pad - q.shape[1]))
    keys, idxp = fused_block_select(q.contiguous(), xq, qsc.contiguous(), mult, add)
    cw = min(c, keys.shape[1])
    selk, sel = torch.topk(keys, cw, dim=1)
    cand = pos_to_slot[torch.gather(idxp, 1, sel).long()]
    # keys at/below DEAD_KEY_MAX mark padding/dead positions (which alias
    # slot 0 through pos_to_slot — key-masking also prevents duplicate ids)
    valid = live[cand] & (selk > DEAD_KEY_MAX)
    d = _rescore(metric, qv, qn, qe, cand, rows, norms, extras, valid)
    return _finish(metric, dims, k, d, slot_to_id, cand)


def _fused_tables(metric, rows, norms, live, int8: bool):
    """Bind-time corpus tables for the fused select kernel (`_fused_tables`).

    Rows are laid out in a fixed pseudorandom position order (numpy
    `default_rng(0x5EEDED)`, bit-identical to the JAX package) so
    insertion-order clustering cannot concentrate a query's neighbours
    into one select block; `pos_to_slot` maps positions back to slots.
    Returns (xq [Mp, d_pad], mult [Mp], add [Mp], pos_to_slot [Mp])."""
    cap, sd = rows.shape
    dev = rows.device
    mp = -(-cap // DEFAULT_BM) * DEFAULT_BM
    if mp // DEFAULT_BM >= DEFAULT_GP:
        mp = -(-mp // (DEFAULT_BM * DEFAULT_GP)) * (DEFAULT_BM * DEFAULT_GP)
    rng = np.random.default_rng(0x5EEDED)
    p2s = np.zeros(mp, np.int64)
    p2s[:cap] = rng.permutation(cap)
    pos_to_slot = torch.from_numpy(p2s).to(dev)
    valid = torch.arange(mp, device=dev) < cap
    rows_p = rows[pos_to_slot]
    if int8:
        mx = torch.amax(torch.abs(rows_p), dim=1)
        iscale = torch.where(mx > 0, mx / 127.0, 1.0)
        xq = torch.clamp(torch.round(rows_p / iscale[:, None]), -127, 127).to(torch.int8)
    else:
        iscale = torch.ones(mp, dtype=torch.float32, device=dev)
        xq = rows_p.to(torch.bfloat16)
    d_pad = -(-sd // 128) * 128
    if d_pad != sd:
        xq = torch.nn.functional.pad(xq, (0, d_pad - sd))
    zeros = torch.zeros(mp, dtype=torch.float32, device=dev)
    if metric.name == "euclidean":
        mult = 2.0 * iscale
        base_add = -torch.sum(rows_p * rows_p, dim=1)
    elif metric.name == "cosine":
        norms_p = norms[pos_to_slot]
        mult = iscale / torch.where(norms_p > 0.0, norms_p, 1.0)
        base_add = zeros
    else:  # dot-product: the query's extra coordinate is 0
        mult = iscale
        base_add = zeros
    add = torch.where(live[pos_to_slot] & valid, base_add, -_INF)
    return xq.contiguous(), mult.contiguous(), add.contiguous(), pos_to_slot


def _exact_bq_matrix(metric, dims, k, rows, norms, slot_to_id, live, qv, qn):
    """Popcount distance matrix (kernel 2) + exact top-k (`_exact_bq_matrix`)."""
    _check_dots_budget(qv.shape[0], rows.shape[0])
    h = bq_hamming_matrix(qv.contiguous(), rows).to(torch.float32)
    if metric.name == "binary quantized euclidean":
        d = 4.0 * h
    elif metric.name == "binary quantized manhattan":
        d = 2.0 * h
    else:  # binary quantized cosine
        pq = rows.shape[1] * WORD_BITS - 2.0 * h
        pnqn = norms[None, :] * qn[:, None]
        ok = pnqn != 0.0
        cos = pq / torch.where(ok, pnqn, 1.0)
        d = torch.where(ok, (1.0 - cos) / 2.0, 0.0)
    d = torch.where(live[None, :], d, _INF)
    return _finish(metric, dims, k, d, slot_to_id)


def _exact_batch(metric, dims, k, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """Per-pair reference formulas against every row (`_exact_batch`),
    chunked over queries to bound the [Bc, M, sd] temporary."""
    step = max(_PAIR_CHUNK_BYTES // max(rows.shape[0] * rows.shape[1] * 8, 1), 1)
    parts = []
    for s in range(0, qv.shape[0], step):
        d = metric.built_distance(
            qv[s : s + step, None, :], qn[s : s + step, None], qe[s : s + step, None],
            rows[None], norms[None], extras[None],
        )
        parts.append(torch.where(live[None, :], d, _INF))
    d = torch.cat(parts) if parts else torch.empty((0, rows.shape[0]), device=rows.device)
    return _finish(metric, dims, k, d, slot_to_id)


def _exact_matmul(metric, dims, k, x2, rows, norms, slot_to_id, live, qv, qn):
    """Matmul brute force for dot-decomposable metrics (`_exact_matmul`)."""
    dots = _f32_matmul(qv, rows)
    if metric.name == "euclidean":
        q2 = torch.sum(qv * qv, dim=1)
        d = torch.clamp(x2[None, :] - 2.0 * dots + q2[:, None], min=0.0)
    elif metric.name == "cosine":
        pnqn = norms[None, :] * qn[:, None]
        ok = pnqn > _F32_EPS
        cos = torch.clamp(dots / torch.where(ok, pnqn, 1.0), -1.0, 1.0)
        d = torch.where(ok, (1.0 - cos) / 2.0, 0.0)
    else:
        d = -dots
    d = torch.where(live[None, :], d, _INF)
    return _finish(metric, dims, k, d, slot_to_id)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def exact_engine_supported(metric) -> bool:
    return metric.binary or metric.name in ("euclidean", "cosine", "dot-product", "manhattan")


def _fused_gate(idx: DeviceIndex, k: int, int8: bool) -> bool:
    """The fused path's correctness gate: the per-block top-2 of nb blocks
    must hold at least ``max(k, 32)`` candidates, and the table must fit."""
    mp = -(-idx.cap // DEFAULT_BM) * DEFAULT_BM
    nb2 = 2 * (mp // DEFAULT_BM)
    xq_bytes = mp * (-(-idx.rows.shape[1] // 128) * 128) * (1 if int8 else 2)
    return nb2 >= max(k, 32) and xq_bytes <= _FUSED_TABLE_BYTES


def make_exact_fn(
    idx: DeviceIndex,
    count: int,
    filter_slots: np.ndarray | None = None,
    precision: str = "auto",
):
    """Device-resident exact searcher: returns ``(fn, route)`` where
    ``fn(qv, qn, qe, qf) -> (ids [B, k] int64, dists [B, k] f32)`` takes
    and returns tensors on the index's device, and ``route`` names the
    stage-1 path: "fused_select", "unfused", "f32x1", "f32",
    "bq_matrix", "exact_batch" or "empty"."""
    if precision not in ("auto", "f32x1", "f32", "bf16", "int8"):
        raise ValueError(f"unknown precision {precision!r}")
    k = max(min(count, max(idx.n_items, 1)), 1)
    metric = idx.metric
    dims = idx.dims
    rows, norms, extras, s2i = idx.rows, idx.norms, idx.extras, idx.slot_to_id

    if idx.n_items == 0:
        def empty_fn(qv, qn, qe, qf):
            b = qv.shape[0]
            return (
                torch.zeros((b, max(count, 1)), dtype=torch.int64, device=idx.device),
                torch.full((b, max(count, 1)), float("nan"), device=idx.device),
            )

        return empty_fn, "empty"

    live = idx.live
    if filter_slots is not None:
        mask = np.zeros(idx.cap, bool)
        mask[np.asarray(filter_slots, np.int64)] = True
        live = live & torch.from_numpy(mask).to(idx.device)

    if metric.binary:
        def bq_fn(qv, qn, qe, qf):
            return _exact_bq_matrix(metric, dims, k, rows, norms, s2i, live, qv, qn)

        return bq_fn, "bq_matrix"

    if metric.name == "manhattan":
        def man_fn(qv, qn, qe, qf):
            _check_dots_budget(qv.shape[0], idx.cap)
            return _exact_batch(metric, dims, k, rows, norms, extras, s2i, live, qv, qn, qe)

        return man_fn, "exact_batch"

    x2 = _row_sq(rows)
    if precision == "f32x1":
        def f32x1_fn(qv, qn, qe, qf):
            _check_dots_budget(qv.shape[0], idx.cap)
            return _exact_f32_direct(
                metric, dims, k, x2, rows, norms, extras, s2i, live, qv, qn, qe
            )

        return f32x1_fn, "f32x1"

    if precision == "f32":
        c32 = min(max(_next_pow2(8 * k), 128), idx.cap)

        def f32_fn(qv, qn, qe, qf):
            _check_dots_budget(qv.shape[0], idx.cap)
            score = _score(metric, _f32_matmul(qv, rows), x2, norms)
            return _two_stage(
                metric, dims, k, c32, score, rows, norms, extras, s2i, live, qv, qn, qe
            )

        return f32_fn, "f32"

    int8 = precision == "int8"  # "auto" resolves to bf16
    c = min(max(_next_pow2(3 * k), 32), idx.cap)
    if _fused_gate(idx, k, int8):
        tables = _fused_tables(metric, rows, norms, live, int8)

        def fused_fn(qv, qn, qe, qf):
            return _exact_fused(
                metric, dims, k, c, int8, tables, rows, norms, extras, s2i, live, qv, qn, qe
            )

        return fused_fn, "fused_select"

    # unfused two-stage (tiny corpora): quantized dots, exact f32 cut
    if int8:
        mx = torch.amax(torch.abs(rows), dim=1)
        iscale = torch.where(mx > 0, mx / 127.0, 1.0)
        rows_q = torch.clamp(torch.round(rows / iscale[:, None]), -127, 127).double()
    else:
        rows_q = rows.to(torch.bfloat16).float()

    def unfused_fn(qv, qn, qe, qf):
        _check_dots_budget(qv.shape[0], idx.cap)
        if int8:
            qmax = torch.amax(torch.abs(qv), dim=1)
            qsc = torch.where(qmax > 0, qmax / 127.0, 1.0)
            qi8 = torch.clamp(torch.round(qv / qsc[:, None]), -127, 127)
            # int8 dots in float64: exact, and defined on every device
            doti = (qi8.double() @ rows_q.T).to(torch.int32)
            dots = doti.to(torch.float32) * (qsc[:, None] * iscale[None, :])
        else:
            dots = _f32_matmul(qv.to(torch.bfloat16).float(), rows_q)
        score = _score(metric, dots, x2, norms)
        return _two_stage(
            metric, dims, k, c, score, rows, norms, extras, s2i, live, qv, qn, qe
        )

    return unfused_fn, "unfused"


# ---------------------------------------------------------------------------
# the forest engine: re-score of a candidate set, and the probe dispatch
# ---------------------------------------------------------------------------

#: candidate-axis chunk for the re-score gather ([B, chunk, d] temporary)
_RESCORE_CHUNK = 512
#: corpora larger than this skip the matmul re-score (the [B, M] dot
#: matrix would dominate memory)
_MATMUL_RESCORE_MAX_ITEMS = 300_000
#: full-width candidate-mask budget for the chunked matmul re-score
#: (1 byte per item per query)
_RESCORE_MASK_BYTES = 512 << 20
#: [B, M] f32 budget above which the re-score must stream chunks
_RESCORE_MATRIX_BYTES = 1 << 30
#: forest-engine traversal="auto" serves the leaf-probe engine at and
#: above this corpus size (the JAX package's policy, kept as it is)
_PROBE_MIN_ITEMS = 262_144

_TRAVERSAL_TODO = (
    "the forest traversal is not ported yet (ROADMAP queue 1: forest "
    "traversal and nns()); use searcher(engine='exact'), or "
    "engine='forest' with traversal='probe'"
)


def _rescore_batch(metric, dims, k, rows, norms, extras, slot_to_id, cand, qv, qn, qe):
    """Exact re-score of [B, cap] candidate slots (-1 pad) → top-k
    (`_rescore_impl`): valid candidates sorted by ascending id and
    deduplicated (the reference's sort_unstable + dedup,
    src/reader.rs:378-379), distances in chunks of `_RESCORE_CHUNK`."""
    b, cap = cand.shape
    valid0 = cand >= 0
    ids = slot_to_id[torch.clamp(cand, min=0)]
    # valid-first is the primary key, so that a genuine id of u32::MAX
    # cannot interleave with invalid padding and dodge the duplicate check
    key = ids + (~valid0).to(torch.int64) * (1 << 32)
    order = torch.argsort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    valid_s = torch.gather(valid0, 1, order)
    slots_s = torch.clamp(torch.gather(cand, 1, order), min=0)
    dup = torch.zeros_like(valid_s)
    dup[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & valid_s[:, :-1]
    invalid = ~valid_s | dup
    d = torch.cat(
        [
            metric.built_distance(
                qv[:, None, :], qn[:, None], qe[:, None],
                rows[sl], norms[sl], extras[sl],
            )
            for sl in torch.split(slots_s, _RESCORE_CHUNK, dim=1)
        ],
        dim=1,
    )
    return _finish(metric, dims, k, torch.where(invalid, _INF, d), slot_to_id, slots_s)


def _rescore_matmul(metric, dims, k, rows, norms, extras, slot_to_id, cand, qv, qn, qe):
    """Matmul re-score (`_rescore_matmul_impl`): one [B, d] x [d, M]
    product plus a [B, M] candidate mask, so duplicates collapse without
    a sort.  Ranking-equivalent to the exact re-score; euclidean distances
    carry matmul-cancellation noise near zero.  f32 dot-decomposable
    metrics only (`rescore_mode` sends the others to `_rescore_batch`)."""
    b = cand.shape[0]
    m = rows.shape[0]
    valid0 = cand >= 0
    mask = torch.zeros((b, m), dtype=torch.bool, device=rows.device)
    qrow = torch.arange(b, device=rows.device)[:, None].expand_as(cand)
    mask[qrow[valid0], cand[valid0].long()] = True
    dots = _f32_matmul(qv, rows)
    if metric.name == "euclidean":
        q2 = torch.sum(qv * qv, dim=1)
        d = torch.clamp(_row_sq(rows)[None, :] - 2.0 * dots + q2[:, None], min=0.0)
    elif metric.name == "cosine":
        pnqn = norms[None, :] * qn[:, None]
        ok = pnqn > _F32_EPS
        cos = torch.clamp(dots / torch.where(ok, pnqn, 1.0), -1.0, 1.0)
        d = torch.where(ok, (1.0 - cos) / 2.0, 0.0)
    else:  # dot-product
        d = -dots
    return _finish(metric, dims, k, torch.where(mask, d, _INF), slot_to_id)


def rescore_mode(metric, b: int, cap: int, m: int, want: str = "auto") -> str:
    if want == "exact" or metric.binary or metric.name == "manhattan":
        return "exact"
    if want == "matmul":
        return "matmul"
    if b * cap < m:
        # candidate volume below the corpus: the per-candidate gather
        # moves fewer bytes than streaming every item through a matmul
        return "exact"
    if b * m * 4 <= _RESCORE_MATRIX_BYTES and m <= _MATMUL_RESCORE_MAX_ITEMS:
        return "matmul"
    if b * m <= _RESCORE_MASK_BYTES:
        # past the [B, M] matrix budget: the traversal streams the matrix
        # in chunks (not ported yet; the filter shortcut re-scores exactly)
        return "matmul_scan"
    return "exact"


def traversal_mode(idx: DeviceIndex, want: str = "auto") -> str:
    """Resolve the forest engine's traversal: the best-first pop walk
    ("xla") or the leaf-probe engine ("probe", `probe.py`).

    ``ARROY_TRAVERSAL=probe|xla`` resolves ``auto`` only — an explicit
    argument always wins.  ``auto`` serves the probe engine at and above
    `_PROBE_MIN_ITEMS` items."""
    from . import probe as _probe

    want = (want or "auto").lower()
    if want == "auto":
        want = os.environ.get("ARROY_TRAVERSAL", "auto").lower()
    if want == "auto" and idx.n_items >= _PROBE_MIN_ITEMS:
        want = "probe"
    if want == "probe" and _probe.supports(idx.metric):
        return "probe"
    return "xla"


def make_search_fn(
    idx: DeviceIndex,
    count: int,
    search_k: int,
    filter_slots: np.ndarray | None = None,
    rescore: str = "exact",
    traversal: str = "auto",
    state=None,
    probe_trees="auto",
    probe_block="auto",
    probe_dtype="auto",
):
    """The forest engine's device-resident search: returns ``(fn, route)``
    where ``fn(qv, qn, qe, qf) -> (ids, dists)`` takes and returns tensors
    on the index's device, and ``route`` is "empty", "filter_pool" (the
    filter pool fits the candidate budget and is re-scored whole) or
    "probe".  The best-first traversal raises `NotImplementedError`.
    ``state`` is the host snapshot the probe builds its tables from."""
    if idx.n_items == 0 or not idx.roots:
        def empty_fn(qv, qn, qe, qf):
            b = qv.shape[0]
            return (
                torch.zeros((b, max(count, 1)), dtype=torch.int64, device=idx.device),
                torch.full((b, max(count, 1)), float("nan"), device=idx.device),
            )

        return empty_fn, "empty"

    has_filter = filter_slots is not None
    csr_total = max(int(idx.leaf_items.shape[0]) - idx.max_leaf, 1)
    sk_exact = min(max(search_k, count), csr_total)

    if has_filter and len(filter_slots) <= sk_exact:
        # The filter pool fits inside the candidate budget: the
        # reference's traversal would (best case) collect exactly these
        # items before re-scoring (reference: src/reader.rs:345-360,
        # 381-391), so skip the forest walk and re-score the whole
        # filter set — exact results over the candidates.
        n_f = len(filter_slots)
        capf = _next_pow2(max(n_f, 1))
        cand_np = np.full(capf, -1, np.int64)
        cand_np[:n_f] = np.asarray(filter_slots, np.int64)
        cand_const = torch.from_numpy(cand_np).to(idx.device)
        kf = max(min(_next_pow2(count), capf), 1)

        def filter_fn(qv, qn, qe, qf):
            b = qv.shape[0]
            mode = rescore_mode(idx.metric, int(b), capf, idx.n_items, rescore)
            impl = _rescore_matmul if mode == "matmul" else _rescore_batch
            return impl(
                idx.metric, idx.dims, kf, idx.rows, idx.norms, idx.extras,
                idx.slot_to_id, cand_const.expand(b, capf), qv, qn, qe,
            )

        return filter_fn, "filter_pool"

    if traversal_mode(idx, traversal) == "probe" and state is not None:
        from .probe import make_probe_fn

        fn = make_probe_fn(
            idx, state, count, sk_exact,
            n_trees=probe_trees, block=probe_block, dtype=probe_dtype,
            filter_slots=filter_slots,
        )
        return fn, "probe"
    raise NotImplementedError(_TRAVERSAL_TODO)


def _pad_count(ids, dists, count):
    ids = ids.cpu().numpy().astype(np.int64)
    dists = dists.cpu().numpy()
    if ids.shape[1] < count:
        pad = count - ids.shape[1]
        ids = np.concatenate([ids, np.zeros((ids.shape[0], pad), ids.dtype)], axis=1)
        dists = np.concatenate(
            [dists, np.full((dists.shape[0], pad), np.nan, dists.dtype)], axis=1
        )
    return ids, dists


def exact_batch(idx: DeviceIndex, qv, qn, qe, count: int, fast: bool = False):
    """Brute-force oracle over host query arrays → numpy (ids, dists).

    ``fast=False`` uses the reference's per-pair formulas; ``fast=True``
    the popcount matrix (BQ) or a matmul (euclidean/cosine/dot-product)."""
    b = np.asarray(qv).shape[0]
    if idx.n_items == 0:
        return np.zeros((b, count), np.int64), np.full((b, count), np.nan, np.float32)
    dev = idx.device
    m = idx.metric
    k = min(count, idx.cap)
    qv_t = (
        torch.from_numpy(np.ascontiguousarray(qv, np.uint32).view(np.int32))
        if m.binary
        else torch.from_numpy(np.ascontiguousarray(qv, np.float32))
    ).to(dev)
    qn_t = torch.from_numpy(np.ascontiguousarray(qn, np.float32)).to(dev)
    qe_t = torch.from_numpy(np.ascontiguousarray(qe, np.float32)).to(dev)
    if fast and m.binary:
        out = _exact_bq_matrix(m, idx.dims, k, idx.rows, idx.norms, idx.slot_to_id, idx.live, qv_t, qn_t)
    elif fast and m.name in ("euclidean", "cosine", "dot-product"):
        out = _exact_matmul(
            m, idx.dims, k, _row_sq(idx.rows), idx.rows, idx.norms, idx.slot_to_id,
            idx.live, qv_t, qn_t,
        )
    else:
        out = _exact_batch(
            m, idx.dims, k, idx.rows, idx.norms, idx.extras, idx.slot_to_id, idx.live,
            qv_t, qn_t, qe_t,
        )
    return _pad_count(*out, count)
