"""The serving engines: exact (brute force) and the forest engine.

Counterpart of `arroy_tpu/search.py`: `make_exact_fn`, `exact_batch`
and their stage functions, and the forest engine `make_search_fn` with
`search_batch` (the empty index, the filter-pool shortcut, the leaf-probe
engine of `probe.py`, and the best-first traversal with its two-tier
budget, its multi-pop variant, leaf-log expansion and three re-score
modes).

The best-first traversal pops a max-queue seeded with every tree root at
+inf, descends split planes pushing children at ``min(parent, ∓margin)``
and collects leaf windows until `search_k` candidates are in (reference:
src/reader.rs:317-401).  The JAX package runs one `lax.while_loop` per
query under `vmap`, and its two-tier budget as a `lax.cond`, all in one
device program.  Here the pop loop is `ops.traverse.traverse`: on the
card kernel 4 (`csrc/traverse.cu`, a warp a query, the whole loop in one
launch), on the CPU its plain version `_traverse_batch`, where the queue
is a [B, q_cap] tensor, each batched pop touches one lane per query by
indexing, a per-query ``active`` mask freezes finished queries exactly
as the vmapped loop does, and the host reads the batch's "any still
active" flag once every `POP_BLOCK` pops.  The multi-pop loop
(`_traverse_multipop`) stays batched PyTorch on both devices.

The exact engine's modes score every live
item of the corpus and return the top-k under the reference's exact
distance formulas:

* ``f32x1`` — f32 matmul distances, a top-4k cut, exact re-score;
* ``f32`` — f32 matmul scores, a top-c cut, exact re-score;
* ``int8`` / ``bf16`` (``auto`` = bf16) — stage 1 is the fused select
  kernel (`ops/fused_select`), which keeps each 256-row block's best two
  packed keys without materializing [B, M]; stage 2 cuts those to ``c``
  candidates and re-scores them exactly in f32 (the oversample + exact
  re-score contract, reference src/reader.rs:381-401).  Corpora too
  small for the per-block top-2 to hold ``max(k, 32)`` candidates, or
  whose table would pass `_FUSED_TABLE_BYTES`, serve the unfused
  two-stage path (quantized dots, an exact f32 top-c cut, the same
  re-score);
* every one of the routes above ends in kernel 5 (`ops/rescore`): on
  the card one launch a batch cuts the keys (fused route) or takes the
  [B, c] candidate list (the others), re-scores each candidate row read
  once from the corpus, and returns the top-k, with no [B, c, d]
  temporary;
* binary-quantized metrics — the popcount distance matrix kernel
  (`ops/bq_kernels`), exact integer distances;
* manhattan — the per-pair formula over every row, in query chunks.

Every mode that builds the [B, M] score matrix streams the corpus
instead when one batch's matrix would pass `_EXACT_DOTS_BYTES`; the
test is per batch, so one searcher serves a small batch by the matrix
and a large one by a scan.  `_exact_scan` (f32x1 and f32 with the rows'
own dtype, unfused int8 and bf16 with bf16 rows) multiplies the queries
by one item chunk of `_scan_chunk(B)` rows at a time, keeps each chunk's
top-k2 scores, merges the winners with one `topk` and re-scores them
exactly in f32.  `_exact_bq_scan` does the same for the BQ metrics,
whose distances are exact and need no re-score: kernel 2 counts each
chunk on the packed words.  The fused route never builds [B, M] and
never scans.  `scan_calls` counts the batches each scan served.

Cuts use exact `torch.topk` (the JAX package's `approx_max_k` has no
counterpart; an exact cut can only raise recall).  Tie order among equal
distances is unspecified, as with any top-k on the GPU.

The item matrix may be bf16 (``ARROY_SERVING_DTYPE=bf16``, see
`DeviceIndex.build`): matmuls then take bf16 queries and accumulate in
f32, and every re-score promotes the gathered rows to f32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import DeviceIndex, _to_device
from .models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT_NONE
from .ops.bq_kernels import bq_hamming_matrix
from .ops.binary import WORD_BITS
from .ops.fused_select import DEFAULT_BM, DEFAULT_GP, fused_block_select
from .ops.rescore import cut_rescore, forest_kernel, forest_rescore, rescore_topk
from .ops.rescore import finish_topk as _finish
from .ops.traverse import POP_BLOCK, traverse
from .ops.traverse import traverse_reference as _traverse_batch  # noqa: F401 (the plain loop's name)
from .utils import profiling

_INF = float("inf")
_F32_EPS = float(np.finfo(np.float32).eps)
#: the [B, M] score matrix budget: a batch whose matrix would pass it
#: streams item chunks (`_exact_scan`, `_exact_bq_scan`) instead
_EXACT_DOTS_BYTES = 4 << 30
#: item-chunk floor of the streamed paths (see `_scan_chunk`)
_EXACT_SCAN_CHUNK = 65_536
#: corpus items per cut-width unit of the int8/bf16 modes (`_cut_width`)
_CUT_ITEMS = 262_144
#: largest fused-select corpus table (int8/bf16 rows) built at bind time
_FUSED_TABLE_BYTES = 3 << 30
#: bytes of one [Bc, M, sd] temporary in the per-pair formula path
_PAIR_CHUNK_BYTES = 256 << 20

#: batches served by each streaming scan (test/smoke observability: the
#: bind-time route cannot show the per-batch choice)
scan_calls = {"exact_scan": 0, "bq_scan": 0}


def _next_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _row_sq(rows: torch.Tensor) -> torch.Tensor:
    r = rows.float()
    return torch.sum(r * r, dim=1)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T with an f32 result.  f32 rows multiply in full f32 (TF32
    would keep ~3 digits of each product; the caller's TF32 setting is
    restored afterwards, as the JAX package sets precision per operation
    and changes no global); bf16 rows take `a` rounded to bf16 and
    accumulate in f32, as the JAX package's ``preferred_element_type=f32``
    does."""
    if b.dtype == torch.float32:
        flags = torch.backends.cuda.matmul
        tf32, flags.allow_tf32 = flags.allow_tf32, False
        try:
            return a @ b.T
        finally:
            flags.allow_tf32 = tf32
    a = a.to(b.dtype)
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T  # a product of two bf16 values is exact in f32


def _scan_chunk(batch: int) -> int:
    """Item-chunk width of the streamed paths: the largest pow2 multiple
    of `_EXACT_SCAN_CHUNK` whose [batch, chunk] distance block stays within
    half the score-matrix budget."""
    c = _EXACT_SCAN_CHUNK
    while batch * (c * 2) * 4 <= _EXACT_DOTS_BYTES // 2:
        c *= 2
    return c


def _streams(b: int, m: int) -> bool:
    """Whether a batch of `b` queries over `m` items must scan: its [B, M]
    f32 matrix would pass `_EXACT_DOTS_BYTES`."""
    return b * m * 4 > _EXACT_DOTS_BYTES


def _chunk_topk(score_of, m: int, chunk: int, kk: int, largest: bool):
    """Top-kk columns of a [B, m] score matrix that is never whole.

    ``score_of(s, e)`` returns columns [s, e) for one chunk of at most
    `chunk` items (the last one may be narrower, so nothing is padded).
    Each chunk keeps its own top-kk and one `topk` merges the stacked
    winners, with no carried merge on the serial path.  Returns
    (scores, columns), [B, min(kk, m)] each."""
    vals, cols = [], []
    for s in range(0, m, chunk):
        sc = score_of(s, min(s + chunk, m))
        v, c = torch.topk(sc, min(kk, sc.shape[1]), dim=1, largest=largest)
        vals.append(v)
        cols.append(c + s)
    v = torch.cat(vals, dim=1)
    best, pos = torch.topk(v, min(kk, v.shape[1]), dim=1, largest=largest)
    return best, torch.gather(torch.cat(cols, dim=1), 1, pos)


def _matmul_distance(metric, dots, aux, qv, qn):
    """Distances from the [B, n] f32 dots of dot-decomposable metrics:
    euclidean x² - 2q·x + q² (``aux`` = x²), cosine (1 - cos)/2 (``aux`` =
    the item norms), dot-product -q·x.  The euclidean form cancels, so
    its near-zero distances carry f32 noise."""
    if metric.name == "euclidean":
        q2 = torch.sum(qv * qv, dim=1)
        return torch.clamp(aux[None, :] - 2.0 * dots + q2[:, None], min=0.0)
    if metric.name == "cosine":
        pnqn = aux[None, :] * qn[:, None]
        ok = pnqn > _F32_EPS
        cos = torch.clamp(dots / torch.where(ok, pnqn, 1.0), -1.0, 1.0)
        return torch.where(ok, (1.0 - cos) / 2.0, 0.0)
    return -dots  # dot-product


def _candidate_mask(cand, m: int):
    """[B, m] bool, True at each query's valid (>= 0) candidate slots:
    duplicates collapse onto one column."""
    b = cand.shape[0]
    valid0 = cand >= 0
    mask = torch.zeros((b, m), dtype=torch.bool, device=cand.device)
    qrow = torch.arange(b, device=cand.device)[:, None].expand_as(cand)
    mask[qrow[valid0], cand[valid0].long()] = True
    return mask


# ---------------------------------------------------------------------------
# stage functions (one per JAX `_exact_*_impl`)
# ---------------------------------------------------------------------------


def _exact_f32_direct(
    metric, dims, k, x2, rows, norms, extras, slot_to_id, live, qv, qn, qe, normalize=True
):
    """f32 matmul distances + top-4k cut + exact re-score and top-k
    (kernel 5, `rescore_topk`) (`_exact_f32_direct_impl`)."""
    aux = x2 if metric.name == "euclidean" else norms
    d = _matmul_distance(metric, _f32_matmul(qv, rows), aux, qv, qn)
    d = torch.where(live[None, :], d, _INF)
    k2 = min(max(4 * k, 32), rows.shape[0])
    d2, cand = torch.topk(d, k2, dim=1, largest=False)
    return rescore_topk(
        metric, dims, k, cand, d2 < _INF, rows, norms, extras, slot_to_id, qv, qn, qe, normalize
    )


def _score(metric, dots, x2, norms):
    """argmax-ordered stage-1 score from dots (euclidean: 2q·x - |x|²)."""
    if metric.name == "euclidean":
        return 2.0 * dots - x2[None, :]
    if metric.name == "cosine":
        return dots / torch.where(norms > 0.0, norms, 1.0)[None, :]
    return dots  # dot-product: the query's extra coordinate is 0


def _two_stage(metric, dims, k, c, score, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """Exact f32 top-c cut of an f32 score matrix, then exact re-score and
    top-k (kernel 5, `rescore_topk`)."""
    score = torch.where(live[None, :], score, -_INF)
    sc, cand = torch.topk(score, c, dim=1)
    valid = live[cand] & (sc > -_INF)
    return rescore_topk(metric, dims, k, cand, valid, rows, norms, extras, slot_to_id, qv, qn, qe)


def _fused_queries(qv, d_pad: int, int8: bool):
    """The fused select's query operands: q [B, d_pad] int8 (per-query
    scale qsc) or bf16 (qsc = 1), zero-padded to the table's width."""
    if int8:
        qmax = torch.amax(torch.abs(qv), dim=1)
        qsc = torch.where(qmax > 0, qmax / 127.0, 1.0)
        q = torch.clamp(torch.round(qv / qsc[:, None]), -127, 127).to(torch.int8)
    else:
        qsc = torch.ones(qv.shape[0], dtype=torch.float32, device=qv.device)
        q = qv.to(torch.bfloat16)
    if d_pad != q.shape[1]:
        q = torch.nn.functional.pad(q, (0, d_pad - q.shape[1]))
    return q.contiguous(), qsc.contiguous()


def _quantized_rows(rows, int8: bool, chunk: int = _EXACT_SCAN_CHUNK):
    """The unfused route's corpus copy, made `chunk` rows at a time (no
    f32 temporary the size of the corpus): int8 rows under a per-row
    max-abs scale, zero-padded to a multiple of 8 rows and columns (the
    int8 GEMM's shape rule), with the scales [cap] f32; or bf16 rows."""
    cap, d = rows.shape
    if not int8:
        return (rows.to(torch.bfloat16),)
    q = torch.zeros((-(-cap // 8) * 8, -(-d // 8) * 8), dtype=torch.int8, device=rows.device)
    iscale = torch.empty(cap, dtype=torch.float32, device=rows.device)
    for s in range(0, cap, chunk):
        rf = rows[s : s + chunk].float()
        mx = torch.amax(torch.abs(rf), dim=1)
        sc = torch.where(mx > 0, mx / 127.0, 1.0)
        q[s : s + len(rf), :d] = torch.clamp(torch.round(rf / sc[:, None]), -127, 127).to(torch.int8)
        iscale[s : s + len(rf)] = sc
    return q, iscale


def _int8_dots(qi8, rows_i8):
    """[B, cap8] int32 dots of int8 queries [B, d] and the padded int8 rows
    [cap8, d8], accumulated in int32 (exact).  The queries are zero-padded
    to d8 columns and to at least 17 rows, the card's int8 GEMM shape rule."""
    b, d = qi8.shape
    pad_rows = max(17 - b, 0)
    if pad_rows or d != rows_i8.shape[1]:
        qi8 = torch.nn.functional.pad(qi8, (0, rows_i8.shape[1] - d, 0, pad_rows))
    return torch._int_mm(qi8, rows_i8.t())[:b]


def _exact_fused(metric, dims, k, c, int8, tables, rows, norms, extras, slot_to_id, live, qv, qn, qe):
    """Fused-select stage 1 (kernel 1) + key cut, exact re-score and top-k
    (kernel 5, `cut_rescore`) (`_exact_fused_impl`)."""
    xq, mult, add, pos_to_slot = tables
    with profiling.span("arroy.exact.select"):
        q, qsc = _fused_queries(qv, xq.shape[1], int8)
        keys, idxp = fused_block_select(q, xq, qsc, mult, add)
    with profiling.span("arroy.exact.rescore"):
        return cut_rescore(
            metric, dims, k, c, keys, idxp, pos_to_slot, live, rows, norms, extras, slot_to_id,
            qv, qn, qe,
        )


@profiling.spanned("arroy.bind.fused_tables")
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
        rf = rows_p.float()
        mx = torch.amax(torch.abs(rf), dim=1)
        iscale = torch.where(mx > 0, mx / 127.0, 1.0)
        xq = torch.clamp(torch.round(rf / iscale[:, None]), -127, 127).to(torch.int8)
        del rf
    else:
        iscale = torch.ones(mp, dtype=torch.float32, device=dev)
        xq = rows_p.to(torch.bfloat16)
    d_pad = -(-sd // 128) * 128
    if d_pad != sd:
        xq = torch.nn.functional.pad(xq, (0, d_pad - sd))
    zeros = torch.zeros(mp, dtype=torch.float32, device=dev)
    if metric.name == "euclidean":
        mult = 2.0 * iscale
        base_add = -_row_sq(rows_p)
    elif metric.name == "cosine":
        norms_p = norms[pos_to_slot]
        mult = iscale / torch.where(norms_p > 0.0, norms_p, 1.0)
        base_add = zeros
    else:  # dot-product: the query's extra coordinate is 0
        mult = iscale
        base_add = zeros
    add = torch.where(live[pos_to_slot] & valid, base_add, -_INF)
    return xq.contiguous(), mult.contiguous(), add.contiguous(), pos_to_slot


def _bq_distance(metric, h, norms, qn, d_pad: int):
    """Exact BQ distances from f32 hamming counts h [B, n]; `norms` are the
    n items' (cosine), `d_pad` the padded width in bits."""
    if metric.name == "binary quantized euclidean":
        return 4.0 * h
    if metric.name == "binary quantized manhattan":
        return 2.0 * h
    pq = d_pad - 2.0 * h  # binary quantized cosine
    pnqn = norms[None, :] * qn[:, None]
    ok = pnqn != 0.0
    cos = pq / torch.where(ok, pnqn, 1.0)
    return torch.where(ok, (1.0 - cos) / 2.0, 0.0)


def _exact_bq_matrix(metric, dims, k, rows, norms, slot_to_id, live, qv, qn, normalize=True):
    """Popcount distance matrix (kernel 2) + exact top-k (`_exact_bq_matrix`)."""
    h = bq_hamming_matrix(qv.contiguous(), rows).to(torch.float32)
    d = _bq_distance(metric, h, norms, qn, rows.shape[1] * WORD_BITS)
    d = torch.where(live[None, :], d, _INF)
    return _finish(metric, dims, k, d, slot_to_id, normalize=normalize)


def _exact_bq_scan(metric, dims, k, chunk, rows, norms, slot_to_id, live, qv, qn, normalize=True):
    """Streaming BQ exact search (`_exact_bq_scan_impl`): memory is bounded
    by [B, chunk] at any corpus size.

    Kernel 2 counts each chunk of the packed words [M, w] (a row slice of
    a contiguous tensor is contiguous).  The JAX package's other branch,
    a matmul on the ±1 bf16 decode of the corpus, gives the same counts
    and is not ported: it was slower on an H100 at 1M x 768 and B = 2048
    (104.1-104.8 ms a batch against 97.2-97.8) and holds 2 bytes a bit
    more (PERF.md §6).  The distances are exact, so the merged winners
    need no re-score; the output is NaN padded past ``min(k, chunk)``."""
    d_pad = rows.shape[1] * WORD_BITS
    qv = qv.contiguous()
    kk = min(k, chunk)

    def dist_of(s, e):
        h = bq_hamming_matrix(qv, rows[s:e]).to(torch.float32)
        d = _bq_distance(metric, h, norms[s:e], qn, d_pad)
        return torch.where(live[None, s:e], d, _INF)

    best, cand = _chunk_topk(dist_of, rows.shape[0], chunk, kk, largest=False)
    scan_calls["bq_scan"] += 1
    ids, out_d = _finish(metric, dims, kk, best, slot_to_id, cand, normalize)
    if kk < k:
        ids = torch.nn.functional.pad(ids, (0, k - kk))
        out_d = torch.nn.functional.pad(
            out_d, (0, k - kk), value=float("nan") if normalize else _INF
        )
    return ids, out_d


def _exact_scan(
    metric, dims, k, chunk, rows_mm, x2, rows, norms, extras, slot_to_id, live, qv, qn, qe,
    normalize=True,
):
    """Streaming exact search (`_exact_scan_impl`): memory is bounded by
    [B, chunk] at any corpus size.

    Each chunk is one matmul of the queries against ``rows_mm`` (f32 or
    bf16; its dtype decides the tensor-core rate, and the sums are f32
    either way), the stage-1 score transform and a top-k2 cut; one `topk`
    merges the winners and a final exact f32 re-score (kernel 5,
    `rescore_topk`, from `rows`) ranks them."""
    k2 = max(min(_next_pow2(8 * k), chunk), 128)

    def score_of(s, e):
        sc = _score(metric, _f32_matmul(qv, rows_mm[s:e]), x2[s:e], norms[s:e])
        return torch.where(live[None, s:e], sc, -_INF)

    best, cand = _chunk_topk(score_of, rows_mm.shape[0], chunk, k2, largest=True)
    scan_calls["exact_scan"] += 1
    return rescore_topk(
        metric, dims, k, cand, live[cand] & (best > -_INF), rows, norms, extras, slot_to_id,
        qv, qn, qe, normalize,
    )


def _exact_batch(metric, dims, k, rows, norms, extras, slot_to_id, live, qv, qn, qe, normalize=True):
    """Per-pair reference formulas against every row (`_exact_batch`),
    chunked over queries to bound the [Bc, M, sd] temporary; each chunk
    keeps only its top-k, so no [B, M] matrix is ever whole."""
    step = max(_PAIR_CHUNK_BYTES // max(rows.shape[0] * rows.shape[1] * 8, 1), 1)
    parts = []
    for s in range(0, max(qv.shape[0], 1), step):
        d = metric.built_distance(
            qv[s : s + step, None, :], qn[s : s + step, None], qe[s : s + step, None],
            rows[None], norms[None], extras[None],
        )
        parts.append(_finish(
            metric, dims, k, torch.where(live[None, :], d, _INF), slot_to_id, normalize=normalize
        ))
    return torch.cat([i for i, _ in parts]), torch.cat([d for _, d in parts])


def _exact_matmul(metric, dims, k, x2, rows, norms, slot_to_id, live, qv, qn):
    """Matmul brute force for dot-decomposable metrics (`_exact_matmul`)."""
    aux = x2 if metric.name == "euclidean" else norms
    d = _matmul_distance(metric, _f32_matmul(qv, rows), aux, qv, qn)
    return _finish(metric, dims, k, torch.where(live[None, :], d, _INF), slot_to_id)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def exact_engine_supported(metric) -> bool:
    return metric.binary or metric.name in ("euclidean", "cosine", "dot-product", "manhattan")


def _cut_width(k: int, cap: int) -> int:
    """Candidates the int8/bf16 modes keep for the exact re-score: the JAX
    package's ``max(next_pow2(3k), 32)`` for every `_CUT_ITEMS` items or
    part of them, rounded up to a power of two.  The items whose quantized
    score can overtake the k-th best grow with the corpus: on an H100 at
    768-d, B = 2048, c = 32 held int8 recall@10 at 0.9963 / 0.9920 /
    0.9892 / 0.9869 at 262,144 / 524,288 / 1M / 2M items, and this width
    (32 / 64 / 128 / 256) at 0.9963 / 0.9966 / 0.9970 / 0.9975
    (`scripts/torch_cut_width.py`, PERF.md §6)."""
    return min(max(_next_pow2(3 * k), 32) * _next_pow2(-(-cap // _CUT_ITEMS)), cap)


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
    stage-1 path chosen at bind time: "fused_select", "unfused", "f32x1",
    "f32", "bq_matrix", "exact_batch" or "empty".  The "unfused", "f32x1",
    "f32" and "bq_matrix" routes choose per batch between the [B, M]
    matrix and a streaming scan (`_streams`); the scan's bf16 copy of f32
    rows is made on the first batch that needs it and kept."""
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
        @profiling.spanned("arroy.exact.bq_matrix")
        def bq_fn(qv, qn, qe, qf):
            b = int(qv.shape[0])
            if not _streams(b, idx.cap):
                return _exact_bq_matrix(metric, dims, k, rows, norms, s2i, live, qv, qn)
            return _exact_bq_scan(metric, dims, k, _scan_chunk(b), rows, norms, s2i, live, qv, qn)

        return bq_fn, "bq_matrix"

    if metric.name == "manhattan":
        @profiling.spanned("arroy.exact.exact_batch")
        def man_fn(qv, qn, qe, qf):
            return _exact_batch(metric, dims, k, rows, norms, extras, s2i, live, qv, qn, qe)

        return man_fn, "exact_batch"

    x2 = _row_sq(rows)
    scan_rows: dict = {}

    def scan(qv, qn, qe, dtype):
        """The streaming scan of a batch past the [B, M] budget, with the
        rows in `dtype` (a copy made once, unless the rows are in it)."""
        if dtype not in scan_rows:
            scan_rows[dtype] = rows.to(dtype)
        return _exact_scan(
            metric, dims, k, _scan_chunk(int(qv.shape[0])), scan_rows[dtype], x2, rows,
            norms, extras, s2i, live, qv, qn, qe,
        )

    if precision == "f32x1":
        @profiling.spanned("arroy.exact.f32x1")
        def f32x1_fn(qv, qn, qe, qf):
            if _streams(int(qv.shape[0]), idx.cap):
                return scan(qv, qn, qe, rows.dtype)
            return _exact_f32_direct(
                metric, dims, k, x2, rows, norms, extras, s2i, live, qv, qn, qe
            )

        return f32x1_fn, "f32x1"

    if precision == "f32":
        c32 = min(max(_next_pow2(8 * k), 128), idx.cap)

        @profiling.spanned("arroy.exact.f32")
        def f32_fn(qv, qn, qe, qf):
            if _streams(int(qv.shape[0]), idx.cap):
                return scan(qv, qn, qe, rows.dtype)
            score = _score(metric, _f32_matmul(qv, rows), x2, norms)
            return _two_stage(
                metric, dims, k, c32, score, rows, norms, extras, s2i, live, qv, qn, qe
            )

        return f32_fn, "f32"

    int8 = precision == "int8"  # "auto" resolves to bf16
    c = _cut_width(k, idx.cap)
    if _fused_gate(idx, k, int8):
        tables = _fused_tables(metric, rows, norms, live, int8)

        @profiling.spanned("arroy.exact.fused_select")
        def fused_fn(qv, qn, qe, qf):
            return _exact_fused(
                metric, dims, k, c, int8, tables, rows, norms, extras, s2i, live, qv, qn, qe
            )

        fused_fn.tables = tables  # (xq, mult, add, pos_to_slot), for inspection

        return fused_fn, "fused_select"

    # unfused two-stage (tiny corpora, or tables past the fused cap):
    # quantized dots and an exact f32 cut under the budget, the bf16 scan
    # past it (int8 too, as in the JAX package)
    quant: list = []

    @profiling.spanned("arroy.exact.unfused")
    def unfused_fn(qv, qn, qe, qf):
        if _streams(int(qv.shape[0]), idx.cap):
            return scan(qv, qn, qe, torch.bfloat16)
        if not quant:  # the quantized rows, made on the first batch under the budget
            quant.extend(_quantized_rows(rows, int8))
        if int8:
            rows_i8, iscale = quant
            qmax = torch.amax(torch.abs(qv), dim=1)
            qsc = torch.where(qmax > 0, qmax / 127.0, 1.0)
            qi8 = torch.clamp(torch.round(qv / qsc[:, None]), -127, 127).to(torch.int8)
            doti = _int8_dots(qi8, rows_i8)[:, : idx.cap]
            dots = doti.to(torch.float32) * (qsc[:, None] * iscale[None, :])
        else:
            dots = _f32_matmul(qv, quant[0])
        score = _score(metric, dots, x2, norms)
        return _two_stage(
            metric, dims, k, c, score, rows, norms, extras, s2i, live, qv, qn, qe
        )

    unfused_fn.quant = quant  # (rows_i8, iscale) or (rows_bf16,), for inspection

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
#: optimistic pop budget of the two-tier traversal, in units of EXPECTED
#: leaf pops (search_k / mean leaf size), plus a pad (the JAX package's
#: values): a truncated query sends its batch to the full budget
_SMALL_POPS_MULT = 32
_SMALL_POPS_PAD = 256


def _rescore_batch(
    metric, dims, k, rows, norms, extras, slot_to_id, cand, qv, qn, qe, normalize=True
):
    """Exact re-score of [B, cap] candidate slots (-1 pad) → top-k
    (`_rescore_impl`): valid candidates sorted by ascending id and
    deduplicated (the reference's sort_unstable + dedup,
    src/reader.rs:378-379), then kernel 5 once a batch where
    `forest_kernel` says so, else distances in chunks of `_RESCORE_CHUNK`
    (the plain chain, on every device)."""
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
    if forest_kernel(metric, rows.device):
        return forest_rescore(metric, dims, k, slots_s, ~invalid, rows, norms, extras,
                              slot_to_id, qv, qn, qe, normalize)
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
    return _finish(metric, dims, k, torch.where(invalid, _INF, d), slot_to_id, slots_s, normalize)


def _rescore_matmul(metric, dims, k, rows, norms, extras, slot_to_id, cand, qv, qn, qe):
    """Matmul re-score (`_rescore_matmul_impl`): one [B, d] x [d, M]
    product plus a [B, M] candidate mask, so duplicates collapse without
    a sort.  Ranking-equivalent to the exact re-score; euclidean distances
    carry matmul-cancellation noise near zero.  f32 dot-decomposable
    metrics only (`rescore_mode` sends the others to `_rescore_batch`)."""
    mask = _candidate_mask(cand, rows.shape[0])
    aux = _row_sq(rows) if metric.name == "euclidean" else norms
    d = _matmul_distance(metric, _f32_matmul(qv, rows), aux, qv, qn)
    return _finish(metric, dims, k, torch.where(mask, d, _INF), slot_to_id)


def _rescore_matmul_scan(metric, dims, k, chunk, slot_to_id, rows, aux, cand, qv, qn, qe):
    """Chunked matmul re-score for corpora past the [B, M] matrix budget
    (`_rescore_matmul_scan_impl`): the candidate mask of `_rescore_matmul`,
    but the distance matrix is streamed [B, chunk] at a time
    (`_chunk_topk`) and a final per-pair pass re-scores the winners
    exactly (matmul distances carry f32 cancellation noise).  ``aux`` is
    the per-item term (x² for euclidean, the norm for cosine).  The JAX
    package cuts each chunk with `approx_max_k`; `topk` here is exact."""
    m = rows.shape[0]
    mask = _candidate_mask(cand, m)
    kk = min(max(_next_pow2(8 * k), 64), chunk)

    def dist_of(s, e):
        d = _matmul_distance(metric, _f32_matmul(qv, rows[s:e]), aux[s:e], qv, qn)
        return torch.where(mask[:, s:e], d, _INF)

    best_d, best_i = _chunk_topk(dist_of, m, chunk, kk, largest=False)
    kk = best_d.shape[1]
    # final exact pass over the kk winners (per-pair reference formulas)
    zeros = torch.zeros_like(best_d)
    xn = aux[best_i] if metric.name == "cosine" else zeros
    d_exact = metric.built_distance(
        qv[:, None, :], qn[:, None], qe[:, None], rows[best_i], xn, zeros
    )
    d_exact = torch.where(best_d < _INF, d_exact, _INF)
    kf = min(k, kk)
    out_d, pos = torch.topk(d_exact, kf, dim=1, largest=False)
    cand_f = torch.gather(best_i, 1, pos)
    out_ids = slot_to_id[torch.clamp(cand_f, max=slot_to_id.shape[0] - 1)]
    out_d = torch.where(out_d < _INF, metric.normalized_distance(out_d, dims), float("nan"))
    if kf < k:
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kf))
        out_d = torch.nn.functional.pad(out_d, (0, k - kf), value=float("nan"))
    return out_ids, out_d


#: the metrics `_matmul_distance` computes: a matmul re-score serves these
#: only.  The JAX package also sends a custom metric (`register_metric`)
#: there, where its branch computes dot-product distances whatever the
#: metric's formulas (wrong ids, distances of 0 for a custom euclidean);
#: the port re-scores a custom metric per candidate with its own formulas.
_MATMUL_METRICS = ("euclidean", "cosine", "dot-product")


def rescore_mode(metric, b: int, cap: int, m: int, want: str = "auto") -> str:
    if want == "exact" or metric.binary or metric.name not in _MATMUL_METRICS:
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
        # in chunks (`_rescore_matmul_scan`), materializing only the
        # 1-byte candidate mask at full width; the filter-pool shortcut,
        # as in the JAX package, re-scores per candidate instead
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


def resolve_multipop(n_items: int, want="auto") -> int:
    """Pops per traversal step (the JAX package's signature; ``n_items``
    does not change the answer): ``"auto"`` reads ``ARROY_MULTIPOP`` and
    otherwise means 1, the reference's strict best-first order.  The JAX
    package keeps "auto" at 1 by a TPU measurement; the H100's is in
    PERF.md (chip_smoke phase 7), and a change of it is a benchmark's."""
    if want is None or want == "auto":
        env = os.environ.get("ARROY_MULTIPOP")
        return max(int(env), 1) if env is not None else 1
    return max(int(want), 1)


def pop_bound(n_nodes: int, n_trees: int, n_splits: int, n_dead_pops: int, leaf_pops,
              search_k: int, full: bool, selectivity: float = 1.0) -> int:
    """Static pop bound for the traversal loop (the JAX package's, as it is).

    Unfiltered, every non-empty leaf pop yields >= 1 candidate, so the
    structure bounds the pops: every split once, the ``leaf_pops``
    smallest leaves first, every empty or FREE row once (no tight bound
    where ``leaf_pops`` is None).  With a candidate filter only a
    ``selectivity`` fraction of each window counts toward search_k, so
    the budget scales by 1/selectivity, bounded by the whole forest.  The
    sharded forest passes its maxima over shards."""
    t = max(n_trees, 1)
    if full:
        return n_nodes + t
    sel = min(max(float(selectivity), 1e-9), 1.0)
    budget = min(n_nodes + t, 2 * t + int(np.ceil(2.0 * search_k / sel)) + 64)
    if sel >= 1.0 and leaf_pops is not None:
        budget = min(budget, n_splits + leaf_pops + n_dead_pops + t + 8)
    return budget


def traversal_caps(n_trees: int, pmax: int, n_splits: int, sk: int, leaf_pops: int, P: int = 1):
    """(q_cap, l_cap): tight widths from the index structure (capacity
    only, results unchanged): a push per split pop; non-empty leaf pops
    bounded by the smallest-leaves-first worst case; P-wide pops overshoot
    both by up to P - 1 before the loop stops."""
    t = max(n_trees, 1)
    return t + min(pmax, n_splits) + 1 + P - 1, min(sk, pmax, leaf_pops) + 1 + P - 1


def pops_budget(idx: DeviceIndex, search_k: int, exhaustive: bool, selectivity: float = 1.0) -> int:
    """`pop_bound` of one device index."""
    leaf_pops = None if idx.leaf_cum_np is None else idx.max_leaf_pops(search_k)
    return pop_bound(idx.n_nodes, len(idx.roots), idx.n_splits, idx.n_dead_pops, leaf_pops,
                     search_k, exhaustive or search_k >= idx.n_items, selectivity)


def _traverse_multipop(margins, node_table, roots, search_k_dyn, pmax, P, q_cap, l_cap, stats=None):
    """The multi-pop pop loop of a query batch (`_traverse_multipop_impl`
    with ``expand=False``): each step pops the best entry of EVERY one of
    P queue segments, a documented deviation from the reference's strict
    best-first order (reference: src/reader.rs:345-372; PARITY.md
    deviation 11).  The global best is always among the P pops; an entry
    skipped this step stays queued.

    The queue is a [P, L] grid (``q_cap`` rounded up to a multiple of P,
    at least 2·P).  Logical slot k lives at physical lane
    ``(k mod P)·L + k div P``, so the right children pushed at contiguous
    logical slots from ``n_pushed`` spread over the segments.  Leaf
    windows are logged in pop order through a [P] rank table (the r-th
    logged pop of a step goes to slot ``n_leaf + r``).  Per-query state
    is [B, 1] or [B, P], each lane read with `gather` and written with
    `scatter_` (column ``q_cap`` of the queue and ``l_cap - 1`` of the log
    take the masked-off writes); finished queries are frozen by the
    ``active`` mask, and the host reads "any query active" once every
    `POP_BLOCK` steps.  Returns ``(leaf_log [B, l_cap], pops, n_cand)`` as
    `_traverse_batch` does unfiltered (and fills ``stats`` as it does)."""
    b, s_rows = margins.shape
    dev = margins.device
    t = int(roots.shape[0])
    q_cap = max(q_cap, 2 * P)
    q_cap = -(-q_cap // P) * P
    L = q_cap // P
    lane = torch.arange(q_cap, device=dev)
    k_of_j = (lane % L) * P + lane // L
    pq_dist = torch.full((b, q_cap + 1), -_INF, device=dev)
    pq_node = torch.zeros((b, q_cap + 1), dtype=torch.int64, device=dev)
    pq_dist[:, :q_cap] = torch.where(k_of_j < t, _INF, -_INF)
    pq_node[:, :q_cap] = torch.where(k_of_j < t, roots[k_of_j.clamp(max=t - 1)], 0)
    dist_v, node_v = pq_dist[:, :q_cap], pq_node[:, :q_cap]
    r = torch.arange(P, device=dev)[None, :]  # a step's ranks, and its segments
    seg_base = r * L
    targets = (r + 1).expand(b, P).contiguous()
    leaf_log = torch.zeros((b, l_cap), dtype=torch.int64, device=dev)
    n_leaf = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    n_pushed = torch.full((b, 1), t, dtype=torch.int64, device=dev)
    n_cand = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    pops = torch.zeros((b, 1), dtype=torch.int64, device=dev)

    def running():
        return (n_cand < search_k_dyn) & (pops < pmax)

    done = 0
    while done < pmax:
        steps = min(POP_BLOCK, pmax - done)
        for _ in range(steps):
            active = running()
            # segment-max pop: the first maximal lane of each segment
            grid = dist_v.view(b, P, L)
            vals = grid.amax(dim=2)
            idxs = seg_base + grid.argmax(dim=2)  # [B, P] physical lanes
            alive = vals > -_INF
            nids = torch.gather(node_v, 1, idxs)
            # kind, left, right, ptr, leaf_off, leaf_cnt
            rows = node_table.index_select(0, nids.view(-1)).view(b, P, -1).long()
            knd, p = rows[..., 0], rows[..., 3]
            go = active & alive
            is_leaf = go & (knd == KIND_LEAF)
            is_split = go & (knd != KIND_LEAF) & (knd != KIND_FREE)
            # leaf pops: the non-empty windows, logged at contiguous slots
            cnt = torch.where(is_leaf, rows[..., 5], 0)
            csum = (cnt > 0).cumsum(dim=1)
            n_log = csum[:, -1:]
            lane_of = torch.searchsorted(csum, targets).clamp(max=P - 1)
            at = n_leaf + r
            log_ok = (r < n_log) & (at < l_cap - 1)
            leaf_log.scatter_(1, torch.where(log_ok, at, l_cap - 1), torch.gather(p, 1, lane_of))
            n_leaf = torch.minimum(n_leaf + n_log, torch.full_like(n_leaf, l_cap - 1))
            n_cand += cnt.sum(dim=1, keepdim=True)
            # split pops: the left child takes the popped lane, every other
            # pop drains it to -inf (keeping its node)
            margin = torch.gather(margins, 1, p.clamp(0, s_rows - 1))
            margin = torch.where(knd == KIND_SPLIT_NONE, 0.0, margin)
            tgt = torch.where(active, idxs, q_cap)
            pq_dist.scatter_(1, tgt, torch.where(is_split, torch.minimum(vals, -margin), -_INF))
            pq_node.scatter_(1, tgt, torch.where(is_split, rows[..., 1], nids))
            # right children at logical slots n_pushed, n_pushed + 1, ...
            csum = is_split.cumsum(dim=1)
            ns = csum[:, -1:]
            lane_of = torch.searchsorted(csum, targets).clamp(max=P - 1)
            slot = n_pushed + r
            tgt = torch.where((r < ns) & (slot < q_cap), (slot % P) * L + slot // P, q_cap)
            pq_dist.scatter_(1, tgt, torch.gather(torch.minimum(vals, margin), 1, lane_of))
            pq_node.scatter_(1, tgt, torch.gather(rows[..., 2], 1, lane_of))
            n_pushed += ns
            n_alive = alive.sum(dim=1, keepdim=True)
            pops = torch.where(active, torch.where(n_alive > 0, pops + n_alive, pmax), pops)
        done += steps
        if not bool(running().any()):  # the one host sync of a block
            break
    if stats is not None:
        stats["steps"] = done
    leaf_log[:, l_cap - 1] = n_leaf.view(-1)
    return leaf_log, pops.view(-1), n_cand.view(-1)


def _expand_log(log, leaf_off, leaf_cnt, leaf_items, cap):
    """Leaf logs [B, l_cap] → [B, cap] candidate slots, -1 padded
    (`_expand_one_log` over a batch).

    Run-length decode of the CSR windows the traversal popped: row j of a
    log covers output positions [ends[j-1], ends[j]), so scattering each
    row's count at its end position and its CSR-offset delta at its begin
    position, then prefix-summing, gives every output position its row's
    output start and CSR offset in O(cap).  `scatter_add_` accumulates
    duplicate positions (stale rows, ends clamped to the trash column)."""
    b, l_cap = log.shape
    dev = log.device
    live = torch.arange(l_cap, device=dev)[None, :] < log[:, l_cap - 1 :]
    li = log.clamp(0, leaf_cnt.shape[0] - 1)  # the tail slot holds a count
    counts = torch.where(live, leaf_cnt[li].long(), 0)
    offs = torch.where(live, leaf_off[li].long(), 0)
    ends = counts.cumsum(dim=1)
    begins = ends - counts
    acc = torch.zeros((b, cap + 1), dtype=torch.int64, device=dev)
    acc.scatter_add_(1, ends.clamp(max=cap), counts)  # counts == ends[j] - ends[j-1]
    start = acc[:, :cap].cumsum(dim=1)
    d_off = torch.where(live, offs - torch.nn.functional.pad(offs[:, :-1], (1, 0)), 0)
    acc2 = torch.zeros((b, cap + 1), dtype=torch.int64, device=dev)
    acc2.scatter_add_(1, begins.clamp(max=cap), d_off)
    off = acc2[:, :cap].cumsum(dim=1)
    cap_iota = torch.arange(cap, device=dev)
    src = (off + (cap_iota - start)).clamp(0, leaf_items.shape[0] - 1)
    total = ends[:, -1:].clamp(max=cap)
    return torch.where(cap_iota < total, leaf_items[src].long(), -1)


class TraversalFn:
    """A bound best-first traversal searcher (`make_search_fn`'s traversal
    route): ``fn(qv, qn, qe, qf) -> (ids [B, k] int64, dists [B, k])`` on
    the index's device, in four stages — `margins`, `walk` (the pop loop,
    two-tier when unfiltered and the small budget is under half the full
    one), `expand` and `rescore`.

    Geometry (host ints): ``pmax``, ``pmax_small``, ``two_tier``,
    ``q_cap_small``, ``q_cap``, ``l_cap`` and ``P``, the pops a step of the
    small tier takes (`_traverse_multipop` when > 1; the full budget and a
    single tier pop one at a time, and a filter forces 1, as in the JAX
    package).  ``fallbacks`` counts batches that the small tier truncated
    and the full budget re-ran; ``last_pops`` [B], ``last_small_ok`` and
    ``last_steps`` (pop-loop steps, both tiers) describe the last batch.

    On the card at P = 1, `walk` never reads the host: it launches kernel
    4 once, at the full budget: a query that the small tier does not cut
    pops the same sequence at either budget, and a batch the small tier
    cuts re-runs at the full one, so every query's output is the two-tier
    walk's.  The tier's outcome is computed on the device from the pops
    and counts: ``fallbacks`` counts the batches whose small tier would
    have been cut; they are read from the card only when asked.  At P > 1
    the small tier is the plain multi-pop loop, which reads the host every
    `POP_BLOCK` steps, and the tier is decided on the host as on the CPU;
    its fallback is kernel 4.  Where kernel 4 ran, ``last_steps`` counts
    its longest query's pops."""

    def __init__(
        self, idx: DeviceIndex, count: int, sk_exact: int, filter_slots, rescore: str,
        multipop="auto",
    ):
        self.idx = idx
        self.rescore_want = rescore
        has_filter = filter_slots is not None
        if has_filter:
            words = np.zeros(max((idx.cap + 31) // 32, 1), np.uint32)
            fs = np.asarray(filter_slots, dtype=np.int64)
            np.bitwise_or.at(words, fs >> 5, np.uint32(1) << (fs & 31).astype(np.uint32))
            self.filter_words = torch.from_numpy(words.view(np.int32)).to(idx.device)
            selectivity = len(filter_slots) / max(idx.n_items, 1)
        else:
            self.filter_words = None
            selectivity = 1.0
        self.sk_exact = sk_exact
        self.sk = _next_pow2(sk_exact)
        self.cap = self.sk + idx.max_leaf
        self.k = max(min(_next_pow2(count), self.cap), 1)
        self.pmax = pops_budget(idx, sk_exact, False, selectivity)
        t = max(len(idx.roots), 1)
        P = 1 if has_filter else resolve_multipop(idx.n_items, multipop)
        self.q_cap, self.l_cap = traversal_caps(t, self.pmax, idx.n_splits, self.sk,
                                                idx.max_leaf_pops(self.sk), P)
        # two tiers: the per-pop cost grows with the queue width, and the
        # always-safe q_cap is 10-100x what a real query needs, so an
        # optimistic pass runs at an expected budget (mean-sized leaves,
        # x32) and a truncated batch re-runs at the full one
        if idx.leaf_cum_np is not None and len(idx.leaf_cum_np):
            mean_leaf = float(idx.leaf_cum_np[-1]) / len(idx.leaf_cum_np)
        else:
            mean_leaf = float(max(idx.max_leaf, 1))
        exp_leaf_pops = int(np.ceil(sk_exact / max(mean_leaf, 1.0)))
        self.pmax_small = min(self.pmax, _SMALL_POPS_MULT * exp_leaf_pops + _SMALL_POPS_PAD)
        self.two_tier = (not has_filter) and self.pmax_small < self.pmax // 2
        # a single tier runs at the full queue width, where the JAX
        # package's [P, L] updates faulted its device: one pop a step there
        self.P = P if self.two_tier else 1
        self.q_cap_small = t + min(self.pmax_small, idx.n_splits) + 1 + self.P - 1
        self.roots = torch.tensor(idx.roots, dtype=torch.int64, device=idx.device)
        # host values on the CPU; device tensors where the card decided
        self._fallbacks = 0
        self._cut = None  # the last batch's small tier was cut
        self._steps = 0  # plain-loop steps of the last batch
        self._kernel_ran = False  # kernel 4 ran in the last batch
        self.last_pops = None
        self._scan_aux = None

    @property
    def fallbacks(self) -> int:
        return int(self._fallbacks)

    @property
    def last_small_ok(self):
        return None if self._cut is None else not bool(self._cut)

    @property
    def last_steps(self) -> int:
        if self._kernel_ran:
            return self._steps + int(self.last_pops.max())
        return self._steps

    @profiling.spanned("arroy.traversal.margins")
    def margins(self, qv, qf):
        idx = self.idx
        return idx.metric.margin_matrix(idx.normals, idx.aux, qv, qf)

    def traverse(self, margins, pmax: int, q_cap: int, P: int = 1):
        """One pop loop at the given budget: `ops.traverse.traverse` (kernel
        4 on the card), or `_traverse_multipop` at ``P`` > 1."""
        idx = self.idx
        stats = {}
        if P > 1:
            out = _traverse_multipop(margins, idx.node_table, self.roots, self.sk_exact,
                                     pmax, P, q_cap, self.l_cap, stats)
        else:
            out = traverse(
                margins, idx.node_table, idx.leaf_items, self.roots, self.sk, self.sk_exact,
                pmax, idx.max_leaf, q_cap=q_cap, l_cap=self.l_cap,
                filter_words=self.filter_words, stats=stats,
            )
            self._kernel_ran = margins.device.type == "cuda"
        self._steps += stats.get("steps", 0)  # the plain loops'; kernel 4 fills none
        return out

    @profiling.spanned("arroy.traversal.walk")
    def walk(self, margins):
        """The pop loop of a batch: leaf logs, or filtered candidates."""
        self._steps, self._kernel_ran = 0, False
        if margins.device.type == "cuda" and self.P == 1:
            # kernel 4 once, at the full budget (see the class docstring)
            out, pops, n_cand = self.traverse(margins, self.pmax, self.q_cap)
            if self.two_tier:
                self._cut = ((pops > self.pmax_small) | (n_cand < self.sk_exact)).any()
                self._fallbacks = self._fallbacks + self._cut
        elif self.two_tier:
            out, pops, n_cand = self.traverse(margins, self.pmax_small, self.q_cap_small, self.P)
            # one host read a batch
            self._cut = bool(((pops >= self.pmax_small) & (n_cand < self.sk_exact)).any())
            if self._cut:
                self._fallbacks += 1
                out, pops, _ = self.traverse(margins, self.pmax, self.q_cap)
        else:
            out, pops, _ = self.traverse(margins, self.pmax, self.q_cap)
        self.last_pops = pops
        return out

    @profiling.spanned("arroy.traversal.expand")
    def expand(self, out):
        """Leaf logs → [B, cap] candidate slots (filtered output as it is)."""
        if self.filter_words is not None:
            return out
        idx = self.idx
        return _expand_log(out, idx.leaf_off, idx.leaf_cnt, idx.leaf_items, self.cap)

    def scan_aux(self):
        """The streamed re-score's per-item term (x², the norm or zeros),
        made on first use and kept."""
        if self._scan_aux is None:
            idx = self.idx
            if idx.metric.name == "euclidean":
                self._scan_aux = _row_sq(idx.rows)
            elif idx.metric.name == "cosine":
                self._scan_aux = idx.norms
            else:
                self._scan_aux = torch.zeros(idx.cap, dtype=torch.float32, device=idx.device)
        return self._scan_aux

    def rescore_mode(self, b: int) -> str:
        return rescore_mode(self.idx.metric, b, self.cap, self.idx.n_items, self.rescore_want)

    @profiling.spanned("arroy.traversal.rescore")
    def rescore(self, cand, qv, qn, qe):
        idx = self.idx
        mode = self.rescore_mode(int(qv.shape[0]))
        if mode == "matmul_scan":
            return _rescore_matmul_scan(
                idx.metric, idx.dims, self.k, _scan_chunk(int(qv.shape[0])), idx.slot_to_id,
                idx.rows, self.scan_aux(), cand, qv, qn, qe,
            )
        impl = _rescore_matmul if mode == "matmul" else _rescore_batch
        return impl(
            idx.metric, idx.dims, self.k, idx.rows, idx.norms, idx.extras, idx.slot_to_id,
            cand, qv, qn, qe,
        )

    def run(self, margins, qv, qn, qe):
        """Everything after the margins (a test hands in another's margins)."""
        return self.rescore(self.expand(self.walk(margins)), qv, qn, qe)

    @profiling.spanned("arroy.traversal")
    def __call__(self, qv, qn, qe, qf):
        return self.run(self.margins(qv, qf), qv, qn, qe)


def make_search_fn(
    idx: DeviceIndex,
    count: int,
    search_k: int,
    filter_slots: np.ndarray | None = None,
    rescore: str = "exact",
    traversal: str = "auto",
    multipop="auto",
    state=None,
    probe_trees="auto",
    probe_block="auto",
    probe_dtype="auto",
):
    """The forest engine's device-resident search: returns ``(fn, route)``
    where ``fn(qv, qn, qe, qf) -> (ids, dists)`` takes and returns tensors
    on the index's device, and ``route`` is "empty", "filter_pool" (the
    filter pool fits the candidate budget and is re-scored whole), "probe"
    or "traversal" (the best-first pop loop, a `TraversalFn`).  ``state``
    is the host snapshot the probe builds its tables from; without it the
    probe is never chosen.  ``multipop`` (`resolve_multipop`) sets the
    traversal's pops per step on its small tier."""
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

        @profiling.spanned("arroy.filter_pool")
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
    return TraversalFn(idx, count, sk_exact, filter_slots, rescore, multipop), "traversal"


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


def search_batch(
    idx: DeviceIndex, qv, qn, qe, qf, count: int, search_k: int,
    filter_slots: np.ndarray | None,
):
    """Host wrapper over `make_search_fn` → numpy (ids, dists): the
    `nns()` path.  It takes `make_search_fn`'s defaults, with no host
    snapshot, so it always traverses (as the JAX package's does), and it
    splits batches past 1,024 queries to bound device temporaries."""
    b = np.asarray(qv).shape[0]
    if idx.n_items == 0 or not idx.roots:
        return np.zeros((b, count), np.int64), np.full((b, count), np.nan, np.float32)
    max_b = 1024
    if b > max_b:
        parts = [
            search_batch(
                idx, qv[i : i + max_b], qn[i : i + max_b], qe[i : i + max_b],
                qf[i : i + max_b], count, search_k, filter_slots,
            )
            for i in range(0, b, max_b)
        ]
        return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])
    fn, _ = make_search_fn(idx, count, search_k, filter_slots)
    ids, dists = fn(*(_to_device(a, idx.device) for a in (qv, qn, qe, qf)))
    return _pad_count(ids[:, :count], dists[:, :count], count)


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
