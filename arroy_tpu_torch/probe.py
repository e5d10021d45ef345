"""Leaf-probe serving engine: centroid-ranked block probing of the forest.

Counterpart of `arroy_tpu/probe.py`.  The engine keeps the forest's
partition but replaces the *order* in which it is searched (a documented
deviation from the reference's best-first traversal, PARITY.md):

1. Each of the first T trees' leaves is cut into fixed-size P-item
   blocks (leaf-aligned: blocks never straddle a leaf; leaves larger
   than P are split, the tail is padded).  Block member rows are stored
   contiguously ([NB, P, d], bf16 / f32 / int8 or packed sign bits), one
   copy per probe tree, with a per-block centroid.
2. A query ranks ALL blocks of each tree by its centroid score and
   takes the top-L blocks per tree (`search_k ≈ T·L·P` keeps arroy's
   candidate-budget semantics): on the card one kernel that never writes
   the [B, T·nb_max] scores (kernel 6, `ops/rank_select`), else one
   centroid matmul and `torch.topk`.
3. The selected blocks are scored by the gather-score kernel
   (`ops/gather_score`), which streams each block once and never
   materializes the gathered rows; a top-k2 cut, a slot-dedup and an
   exact f32 re-score produce the final top-k (kernel 5's `rescore_topk`
   on the card for euclidean, cosine and dot-product).

The block tables are packed on the host with numpy, bit-identical to the
JAX package's `build_tables_np` (bf16 rows are rounded by PyTorch, which
rounds to nearest-even like `ml_dtypes`; they travel as uint16 bits).
Cuts use exact `torch.topk` where the JAX package uses `approx_max_k`
(which is exact on its CPU backend); an exact cut can only raise recall.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .metrics import ALL_METRICS
from .models.forest import KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE
from .ops.binary import (
    WORD_BITS,
    n_words,
    pack_bits,
    pack_bits_np,
    popcount32,
    unpack_bits,
    unpack_bits_np,
)
from .ops.gather_score import gather_score
from .ops.rank_select import rank_blocks
from .ops.rescore import forest_kernel, forest_rescore
from .utils import profiling

_INF = float("inf")
_EPS = 1e-30

#: default probe geometry (overridable per Searcher / env): "auto" takes
#: as many trees as the block-table memory budget allows, up to 8
DEFAULT_TREES = os.environ.get("ARROY_PROBE_TREES", "auto")
DEFAULT_BLOCK = int(os.environ.get("ARROY_PROBE_BLOCK", 64))
#: device-memory budget for the duplicated block tables; per-tree cost
#: is ~1.3 x n_items x dims x itemsize (leaf-padding fill ~0.78)
PROBE_BYTES = int(os.environ.get("ARROY_PROBE_BYTES", 4 << 30))
#: budget for the query-time gather temporaries: past it the probe scores
#: blocks (and re-scores candidates) in chunks with per-chunk winners and
#: one final merge.  The chunk rule is the JAX package's, so both take the
#: same chunks; on the card each block chunk is one kernel launch, whose
#: temporary is only [B, ch, P] f32.
PROBE_GATHER_BYTES = int(os.environ.get("ARROY_PROBE_GATHER_BYTES", 1 << 30))


def _per_tree_bytes(idx, dtype: str) -> int:
    if dtype == "bq":
        per_item = n_words(idx.dims) * 4
    elif dtype == "int8":
        per_item = idx.dims + 4  # rows + per-item f32 scale
    else:
        per_item = (2 if dtype == "bf16" else 4) * idx.dims
    return max(int(1.3 * idx.n_items * per_item), 1)


def auto_trees(idx, dtype: str) -> int:
    return max(2, min(PROBE_BYTES // _per_tree_bytes(idx, dtype), 8))


def auto_dtype(idx) -> str:
    """Block-row representation for ``dtype="auto"``: bf16 rows when ≥4
    probe trees fit the table budget; else per-item-max-abs int8 rows
    when ≥3 fit; else packed sign bits scored by XOR-popcount with a
    search_k-tracking exact f32 re-score cut."""
    if PROBE_BYTES // _per_tree_bytes(idx, "bf16") >= 4:
        return "bf16"
    if PROBE_BYTES // _per_tree_bytes(idx, "int8") >= 3:
        return "int8"
    return "bq"


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class ProbeTables:
    """Device-resident block tables for T probe trees (leaf-aligned)."""

    n_trees: int
    block: int
    nb_max: int  # blocks per tree, padded
    fill: float  # real slots / (NB*P) — leaf-padding density
    cent: torch.Tensor  # [T*nb_max, sd] f32 block centroids
    caux: torch.Tensor  # [T*nb_max] f32 centroid score term (‖c‖² or 0)
    valid: torch.Tensor  # [T*nb_max] bool
    blk_rows: torch.Tensor  # [T*nb_max, P, sd] bf16/f32/int8, or int32 words
    blk_aux: torch.Tensor  # [T*nb_max, P] per-item score term
    blk_slots: torch.Tensor  # [T*nb_max, P] int32 slots, -1 pad
    blk_scale: torch.Tensor  # [T*nb_max, P] f32 int8 dequant scale ([1,1] else)

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.cent, self.caux, self.valid, self.blk_rows,
                      self.blk_aux, self.blk_slots, self.blk_scale)
        )


def supports(metric) -> bool:
    """Every built-in metric is probe-servable: f32 metrics through
    bf16/f32/int8/bq block tables, binary-quantized metrics through native
    packed-word blocks scored by XOR-popcount."""
    return True


def _tree_leaves(forest, root: int) -> list[np.ndarray]:
    """Leaf member-id arrays of one tree in DFS order."""
    out: list[np.ndarray] = []
    stack = [int(root)]
    kind, left, right = forest.kind, forest.left, forest.right
    while stack:
        nid = stack.pop()
        k = kind[nid]
        if k == KIND_LEAF:
            out.append(forest.leaves[nid])
        elif k in (KIND_SPLIT, KIND_SPLIT_NONE):
            stack.append(int(right[nid]))
            stack.append(int(left[nid]))
    return out


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 (round to nearest even), as uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def build_tables_np(
    metric, dims: int, store, forest, n_trees: int, block: int, dtype: str = "bf16"
) -> dict:
    """Host-side pack of the probe block tables as NUMPY arrays.

    Bit-identical to the JAX package's; bf16 rows come back as uint16
    bit patterns (numpy has no bfloat16)."""
    P = int(block)
    T = max(1, min(int(n_trees), len(forest.roots)))
    rows = store.rows()
    norms = store.norms()
    sd = rows.shape[1] if rows.ndim == 2 else dims

    name = metric.name
    # probe the T trees with the FEWEST blocks: any trees serve (the
    # union is what buys recall), and the block table is padded to the
    # largest probed tree, so skipping lopsided trees cuts nb_max
    all_leaves = [_tree_leaves(forest, root) for root in forest.roots]
    blocks_of = [
        sum(-(-len(ids) // P) for ids in tree if len(ids))
        for tree in all_leaves
    ]
    order = np.argsort(np.asarray(blocks_of, np.int64), kind="stable")[:T]
    nb_max = max(max((blocks_of[t] for t in order), default=1), 1)

    # vectorized block packing: leaf items are contiguous in block-span
    # order, so each tree is ONE id concat, ONE slots_of, and ONE scatter
    # at arithmetic destinations
    slots_all = np.full((T * nb_max, P), -1, np.int32)
    valid_all = np.zeros(T * nb_max, bool)
    for t, ti in enumerate(order):
        leaves = [ids for ids in all_leaves[ti] if len(ids)]
        if not leaves:
            valid_all[t * nb_max] = True
            continue
        sizes = np.fromiter((len(v) for v in leaves), np.int64, len(leaves))
        slots = store.slots_of(np.concatenate(leaves)).astype(np.int64)
        nsub = -(-sizes // P)  # blocks per leaf
        span_start = np.concatenate([[0], np.cumsum(nsub * P)[:-1]])
        within = np.arange(len(slots), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes
        )
        dest = np.repeat(span_start, sizes) + within
        nb = int(nsub.sum())
        flat = np.full(nb * P, -1, np.int64)
        flat[dest] = slots
        slots_all[t * nb_max : t * nb_max + nb] = flat.reshape(nb, P)
        valid_all[t * nb_max : t * nb_max + nb] = True

    # gather block rows + centroids, chunked over blocks (the full
    # [T*nb, P, d] f32 intermediate is ~32 GB at 1M x 768 x 8 trees)
    NBT = T * nb_max
    n_real = int((slots_all >= 0).sum())
    head = {
        "n_trees": T,
        "block": P,
        "nb_max": nb_max,
        "fill": max(n_real / float(slots_all.size), 1e-6),
        "valid": valid_all,
        "blk_slots": slots_all,
    }
    if metric.binary:
        # binary-quantized metrics: storage is ALREADY packed sign-bit
        # words, so the block table is a direct slice of the item rows.
        # Centroids live in the ±1 decode space; in-block XOR-popcount
        # scores are ranking-exact for all three BQ metrics.
        w = rows.shape[1]
        d_pad = w * WORD_BITS
        brows_out = np.zeros((NBT, P, w), np.uint32)
        baux_all = np.zeros((NBT, P), np.float32)
        cent_all = np.zeros((NBT, d_pad), np.float32)
        caux_all = np.zeros(NBT, np.float32)
        scale_all = np.zeros((1, 1), np.float32)
        chunk = max(1, (512 << 20) // max(P * d_pad * 4, 1))
        cosine = name == "binary quantized cosine"
        for lo in range(0, NBT, chunk):
            hi = min(lo + chunk, NBT)
            sl = slots_all[lo:hi]
            safe = np.maximum(sl, 0)
            live = sl >= 0
            br = rows[safe.reshape(-1)].reshape(hi - lo, P, w)
            br[~live] = 0
            dec = unpack_bits_np(br, d_pad).astype(np.float32)  # ±1
            dec[~live] = 0.0
            cnt = np.maximum(live.sum(axis=1), 1).astype(np.float32)
            c = dec.sum(axis=1) / cnt[:, None]
            if cosine:
                cn = np.linalg.norm(c, axis=1)
                cent_all[lo:hi] = c / np.maximum(cn, 1e-30)[:, None]
            else:
                cent_all[lo:hi] = c
                caux_all[lo:hi] = np.einsum("nd,nd->n", c, c)
            brows_out[lo:hi] = br
        return {**head, "cent": cent_all, "caux": caux_all, "blk_rows": brows_out,
                "blk_aux": baux_all, "blk_scale": scale_all}
    if dtype == "bq":
        # packed sign-bit rows: the in-block score estimates dots from
        # sign agreement scaled by stored norms, so baux = ‖x‖ for EVERY
        # metric here
        brows_out = np.zeros((NBT, P, n_words(sd)), np.uint32)
    elif dtype == "int8":
        # per-item max-abs int8: x ≈ scale_i · r_i8, dot error ~0.4%
        brows_out = np.zeros((NBT, P, sd), np.int8)
    else:
        brows_out = np.zeros((NBT, P, sd), np.uint16 if dtype == "bf16" else np.float32)
    scale_all = (
        np.zeros((NBT, P), np.float32)
        if dtype == "int8"
        else np.zeros((1, 1), np.float32)
    )
    baux_all = np.zeros((NBT, P), np.float32)
    cent_all = np.zeros((NBT, sd), np.float32)
    caux_all = np.zeros(NBT, np.float32)
    chunk = max(1, (512 << 20) // max(P * sd * 4, 1))
    for lo in range(0, NBT, chunk):
        hi = min(lo + chunk, NBT)
        sl = slots_all[lo:hi]
        safe = np.maximum(sl, 0)
        live = sl >= 0
        br = rows[safe.reshape(-1)].reshape(hi - lo, P, sd)
        br[~live] = 0
        nr = norms[safe].astype(np.float32)
        nr[~live] = 0.0
        if dtype == "bq" or name == "cosine":
            baux_all[lo:hi] = nr
        elif name in ("euclidean", "manhattan"):
            baux_all[lo:hi] = nr * nr
        if name == "cosine":
            # spherical centroid: normalized mean of unit member rows
            bn = np.where(live, np.maximum(nr, 1e-30), np.inf)
            c = np.einsum("npd,np->nd", br, (1.0 / bn).astype(np.float32))
            cn = np.linalg.norm(c, axis=1)
            cent_all[lo:hi] = c / np.maximum(cn, 1e-30)[:, None]
        else:
            # euclidean / manhattan / dot-product: mean of raw rows;
            # euclidean-family ranks blocks by 2·q·c − ‖c‖²
            cnt = np.maximum(live.sum(axis=1), 1).astype(np.float32)
            c = br.sum(axis=1) / cnt[:, None]
            cent_all[lo:hi] = c
            if name in ("euclidean", "manhattan"):
                caux_all[lo:hi] = np.einsum("nd,nd->n", c, c)
        if dtype == "bq":
            brows_out[lo:hi] = pack_bits_np(br)
        elif dtype == "int8":
            mx = np.abs(br).max(axis=2)  # [n, P]
            sc = np.maximum(mx, 1e-30) / 127.0
            brows_out[lo:hi] = np.clip(
                np.rint(br / sc[..., None]), -127, 127
            ).astype(np.int8)
            scale_all[lo:hi] = np.where(mx > 0, sc, 0.0)
        elif dtype == "bf16":
            brows_out[lo:hi] = _bf16_bits(br)
        else:
            brows_out[lo:hi] = br.astype(brows_out.dtype)
    return {**head, "cent": cent_all, "caux": caux_all, "blk_rows": brows_out,
            "blk_aux": baux_all, "blk_scale": scale_all}


def _table_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:  # bf16 bit patterns
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:  # packed sign-bit words
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device)


def build_tables(
    metric, dims: int, store, forest, n_trees: int, block: int, dtype: str = "bf16",
    *, device,
) -> ProbeTables:
    """Probe tables on `device`, which the caller names (one upload per
    searcher geometry; cached on the DeviceIndex by `get_tables`)."""
    with profiling.span("arroy.bind.probe_pack"):
        t = build_tables_np(metric, dims, store, forest, n_trees, block, dtype)
    return ProbeTables(
        n_trees=t["n_trees"],
        block=t["block"],
        nb_max=t["nb_max"],
        fill=t["fill"],
        **{
            k: _table_tensor(t[k], device)
            for k in ("cent", "caux", "valid", "blk_rows", "blk_aux", "blk_slots", "blk_scale")
        },
    )


@profiling.spanned("arroy.bind.probe_tables")
def get_tables(idx, state, n_trees: int, block: int, dtype: str) -> ProbeTables:
    """Cached probe tables on the (frozen) DeviceIndex instance."""
    cache = getattr(idx, "_probe_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(idx, "_probe_cache", cache)
    key = (int(n_trees), int(block), dtype)
    hit = cache.get(key)
    if hit is None:
        hit = build_tables(
            idx.metric, idx.dims, state.store, state.forest, n_trees, block, dtype,
            device=idx.device,
        )
        cache[key] = hit
    return hit


def _rank_blocks(metric, L, nb_max, scale, cent, caux, valid, qv) -> torch.Tensor:
    """Stage 1: the top-L blocks of each probe tree → [B, T·L] int64 ids
    (kernel 6 on the card, `ops.rank_select.rank_blocks`).

    Binary metrics store packed queries; the centroid table lives in the
    ±1 decode space, so the query is decoded once here."""
    qcent = unpack_bits(qv, cent.shape[1]) if metric.binary else qv
    return rank_blocks(qcent.contiguous(), cent, caux, valid, scale, L, nb_max)


def gather_chunk(b: int, blk_rows: torch.Tensor) -> int:
    """Blocks per query that stage 2 scores in one chunk: `PROBE_GATHER_BYTES`
    over the bytes a [b, 1, P, d] slab of the JAX package's gathered rows
    and temporaries takes (the JAX package's rule, kept so both take the
    same chunks)."""
    d = blk_rows.shape[-1]
    if blk_rows.dtype == torch.int32:  # packed sign-bit words
        per_slot = d * 8
    elif blk_rows.dtype == torch.int8:
        per_slot = d * 4
    else:
        per_slot = d * (6 if blk_rows.dtype == torch.bfloat16 else 8)
    return max(1, int(PROBE_GATHER_BYTES) // max(b * blk_rows.shape[1] * per_slot, 1))


#: when set, `rescore_cut` returns the JAX package's cut (the tests hold
#: the port to the JAX package's results with it)
JAX_CUT = False
#: past its floor, an exact in-block score's re-score cut is search_k over
#: this share (`rescore_cut`; `scripts/torch_probe_cut.py` measures it)
CUT_SHARE = 8


def block_scale(metric) -> int:
    """Stage 1's factor on the query-centroid dot (2 where the score is
    ``2q·c - ‖c‖²``, the distance's ranking form)."""
    return 2 if metric.name in (
        "euclidean", "manhattan", "binary quantized euclidean", "binary quantized manhattan"
    ) else 1


def rescore_cut(k: int, search_k: int, pool: int, sign_bits: bool, custom: bool) -> int:
    """How many of the in-block winners (of ``pool`` probed slots) reach
    the exact f32 re-score: the probe's one cut rule, used by `make_probe_fn`
    and the sharded probe (`parallel.forest`).

    A generous floor, ``max(32·k, 512)``, washes out bf16 selection noise
    and cross-tree duplicates.  Past it the cut tracks
    ``search_k // CUT_SHARE``: a fixed cut stops recall from rising with
    search_k, and then lowers it, as the in-block top set converges while
    the pool grows (on an H100 the euclidean probe at 262,144 x 768 fell
    from recall@10 0.990 at search_k 8000 to 0.925 at 32000 with the cut
    at 512; PERF.md §6).  The reference re-scores every candidate
    (src/reader.rs:378-401).  An estimate's score (``sign_bits``: sign-bit
    blocks of an f32 metric; ``custom``: a registered metric, scored by
    the dot product) takes the reference's 3x BQ oversampling on the floor
    (src/distance/binary_quantized_cosine.rs:36) and tracks half of
    search_k, the JAX package's rule for its sign-bit estimate.  With
    `JAX_CUT` set, only sign-bit blocks are an estimate and only their
    floor tracks search_k, as in the JAX package."""
    estimate = sign_bits or (custom and not JAX_CUT)
    over = 3 if estimate else 1
    floor = max(32 * k * over, 512 * over)
    if estimate:
        floor = max(floor, int(search_k) // 2)
    elif not JAX_CUT:
        floor = max(floor, int(search_k) // CUT_SHARE)
    return min(_next_pow2(floor), pool)


def blocks_per_tree(T: int, P: int, fill: float, search_k: int, nb_max: int,
                    selectivity: float = 1.0) -> int:
    """Blocks probed per tree, ``L``: search_k counts real candidate slots,
    so the T·P slots of one block per tree are scaled by the leaf-padding
    ``fill``, and by ``selectivity`` when filtered, since only matching
    slots count toward the budget (the single and the sharded probe)."""
    eff = max(int(T * P * fill * selectivity), 1)
    return max(1, min(-(-int(search_k) // eff), nb_max))


def _probe_core(
    metric, dims, k, k2, L, nb_max, scale,
    cent, caux, valid, blk_rows, blk_aux, blk_slots, blk_scale,
    rows, norms, extras, slot_to_id,
    qv, qn, qe,
    fmask=None,
    normalize=True,
):
    """The probe search of one query batch → (ids [B, k] int64, dists [B, k]).

    ``fmask`` ([cap] bool, or None) masks non-candidate slots out of the
    in-block scores (the roaring-∩ role, reference: src/reader.rs:354-360).
    With ``normalize=False`` the distances stay raw, +inf where nothing
    was found (what the sharded probe merges)."""
    name = metric.name
    b = qv.shape[0]
    T = cent.shape[0] // nb_max
    P = blk_rows.shape[1]
    packed = blk_rows.dtype == torch.int32  # sign-bit words (binary metric or "bq")

    # 1. rank all blocks of each probe tree (kernel 6 on the card)
    with profiling.span("arroy.probe.rank"):
        bid = _rank_blocks(metric, L, nb_max, scale, cent, caux, valid, qv)

    # 2. score the selected blocks
    if metric.binary:
        qbits = qv  # already packed sign-bit words
    elif packed:
        qbits = pack_bits(qv)
        qnorm = torch.sqrt(torch.clamp(torch.sum(qv * qv, dim=1), min=0.0))
    else:
        # bf16 and int8 rows meet the query rounded to bf16, as the JAX
        # package serves them (int8→bf16 is exact, bf16·bf16 products are
        # exact in f32), so only the summation order differs
        qk = qv if blk_rows.dtype == torch.float32 else qv.to(torch.bfloat16).float()
        qk = qk.contiguous()

    @profiling.spanned("arroy.probe.score")
    def score_blocks(bidc):
        """Score one [B, c] slab of selected block ids (-1 pad)."""
        safe = torch.clamp(bidc, min=0)
        baux = blk_aux[safe]  # [B, c, P]
        bslot = torch.where((bidc >= 0)[..., None], blk_slots[safe], -1)
        if packed:
            ham = popcount32(
                torch.bitwise_xor(blk_rows[safe], qbits[:, None, None, :])
            ).sum(dim=-1, dtype=torch.int32)
        if metric.binary:
            # XOR popcount IS the distance basis: all three BQ distances
            # are affine in the hamming count, so ranking by -ham is exact
            s2 = -ham.to(torch.float32)
        elif packed:
            # estimate the dot from sign agreement scaled by the stored
            # norms: q·x ≈ ‖q‖‖x‖·bqdot/d_pad; the exact f32 re-score of
            # the (widened) top-k2 fixes the ranking
            d_pad = blk_rows.shape[-1] * WORD_BITS
            bqdot = (d_pad - 2 * ham).to(torch.float32)
            if name in ("euclidean", "manhattan"):
                est_dot = (qnorm[:, None, None] / d_pad) * (baux * bqdot)
                s2 = 2.0 * est_dot - baux * baux
            elif name == "cosine":
                s2 = bqdot  # sign-cosine proxy; norms cancel
            else:
                s2 = baux * bqdot  # raw dot up to the ‖q‖/d_pad const
        else:
            d2 = gather_score(blk_rows, safe.to(torch.int32).contiguous(), qk)
            if blk_rows.dtype == torch.int8:
                d2 = d2 * blk_scale[safe]  # dequant AFTER the dot
            if name in ("euclidean", "manhattan"):
                s2 = 2.0 * d2 - baux
            elif name == "cosine":
                s2 = d2 / torch.clamp(baux, min=_EPS)
            else:
                s2 = d2
        keep = bslot >= 0
        if fmask is not None:
            keep = keep & fmask[torch.clamp(bslot, min=0)]
        return torch.where(keep, s2, -_INF), torch.where(keep, bslot, -1)

    @profiling.spanned("arroy.probe.cut")
    def cut(s2, bslot, width):
        """Top-`width` block scores of a [B, c, P] slab, with their slots."""
        s2f = s2.reshape(b, -1)
        slotf = bslot.reshape(b, -1)
        if width < s2f.shape[1]:
            v, i = torch.topk(s2f, width, dim=1)
            return v, torch.gather(slotf, 1, i)
        return s2f, slotf

    # score in chunks of `ch` blocks with per-chunk winners and one final
    # merge (the JAX package's rule, kept so both take the same chunks)
    C = T * L
    ch = gather_chunk(b, blk_rows)
    if C <= ch:
        sel_s, cand = cut(*score_blocks(bid), k2)
    else:
        nch = -(-C // ch)
        bid_p = torch.nn.functional.pad(bid, (0, nch * ch - C), value=-1)
        k2c = min(k2, ch * P)
        parts = [cut(*score_blocks(bid_p[:, i * ch : (i + 1) * ch]), k2c) for i in range(nch)]
        with profiling.span("arroy.probe.cut"):
            allv = torch.cat([v for v, _ in parts], dim=1)
            alls = torch.cat([s for _, s in parts], dim=1)
            if k2 < allv.shape[1]:
                sel_s, i = torch.topk(allv, k2, dim=1)
                cand = torch.gather(alls, 1, i)
            else:
                sel_s, cand = allv, alls

    # 3. slot-dedup FIRST (cross-tree duplicates are 20-30% at T=4..8),
    # then the exact f32 re-score of each surviving slot, then top-k
    with profiling.span("arroy.probe.rescore"):
        ss, order = torch.sort(cand, dim=1, stable=True)
        sv = torch.gather(sel_s, 1, order)
        dup = torch.zeros_like(ss, dtype=torch.bool)
        dup[:, 1:] = ss[:, 1:] == ss[:, :-1]
        live = (ss >= 0) & (sv > -_INF) & ~dup
        return _rescore_slots(metric, dims, k, ss, live, rows, norms, extras, slot_to_id,
                              qv, qn, qe, normalize)


def _rescore_slots(metric, dims, k, ss, live, rows, norms, extras, slot_to_id, qv, qn, qe,
                   normalize=True):
    """Stage 3 after the dedup: the [B, k2] slot-sorted candidates ``ss``
    (-1 pad) where ``live`` → (ids, dists) as `_probe_core` returns them.
    Kernel 5 once a batch where `forest_kernel` says so; else the plain
    chain, `_rescore_slots_plain`."""
    if not forest_kernel(metric, rows.device):
        return _rescore_slots_plain(metric, dims, k, ss, live, rows, norms, extras, slot_to_id,
                                    qv, qn, qe, normalize)
    cand = torch.clamp(ss, min=0).to(torch.int64)  # the table's slots are int32
    ids, out_d = forest_rescore(metric, dims, k, cand, live, rows, norms, extras, slot_to_id,
                                qv, qn, qe, normalize)
    if normalize:
        ids = torch.where(torch.isnan(out_d), 0, ids)
    return ids, out_d


def _rescore_slots_plain(metric, dims, k, ss, live, rows, norms, extras, slot_to_id, qv, qn, qe,
                         normalize=True):
    """The plain version of `_rescore_slots` (every metric, every device):
    a [B, k2, d] f32 gather with elementwise distances and `torch.topk`,
    past the gather budget in chunks with per-chunk top-k and one final
    merge."""
    b = qv.shape[0]

    def exact_chunk(slots_c, live_c):
        cs = torch.clamp(slots_c, min=0)
        d = metric.built_distance(
            qv[:, None, :], qn[:, None], qe[:, None], rows[cs], norms[cs], extras[cs]
        )
        return torch.where(live_c, d, _INF)

    kq = ss.shape[1]  # actual candidate width (== k2 unless pool < cut)
    per_cand = rows.shape[1] * 8  # gathered f32 rows + distance temps
    ck = max(k, int(PROBE_GATHER_BYTES) // max(b * per_cand, 1))
    if kq <= ck:
        out_d, top_i = torch.topk(exact_chunk(ss, live), k, dim=1, largest=False)
        sel_slots = torch.gather(ss, 1, top_i)
    else:
        nch = -(-kq // ck)
        pad = nch * ck - kq
        ss = torch.nn.functional.pad(ss, (0, pad), value=-1)
        live = torch.nn.functional.pad(live, (0, pad), value=False)
        ds, sl = [], []
        for i in range(nch):
            cs, lv = ss[:, i * ck : (i + 1) * ck], live[:, i * ck : (i + 1) * ck]
            dc, ic = torch.topk(exact_chunk(cs, lv), k, dim=1, largest=False)
            ds.append(dc)
            sl.append(torch.gather(cs, 1, ic))
        out_d, top_i = torch.topk(torch.cat(ds, dim=1), k, dim=1, largest=False)
        sel_slots = torch.gather(torch.cat(sl, dim=1), 1, top_i)
    ids = slot_to_id[torch.clamp(sel_slots, min=0)]
    if not normalize:
        return ids, out_d
    out_d = torch.where(
        out_d < _INF, metric.normalized_distance(out_d, dims), float("nan")
    )
    ids = torch.where(torch.isnan(out_d), 0, ids)
    return ids, out_d


class ProbeFn:
    """A bound leaf-probe searcher: ``fn(qv, qn, qe, qf) -> (ids, dists)``
    on the index's device; `block_ids(qv)` gives stage 1's [B, T·L]
    selection on its own."""

    def __init__(self, idx, tables: ProbeTables, k: int, k2: int, L: int, scale: int, fmask):
        self.idx = idx
        self.tables = tables
        self.k, self.k2, self.L, self.scale = k, k2, L, scale
        self.fmask = fmask

    def block_ids(self, qv: torch.Tensor) -> torch.Tensor:
        t = self.tables
        return _rank_blocks(
            self.idx.metric, self.L, t.nb_max, self.scale, t.cent, t.caux, t.valid, qv
        )

    @profiling.spanned("arroy.probe")
    def __call__(self, qv, qn, qe, qf):
        idx, t = self.idx, self.tables
        return _probe_core(
            idx.metric, idx.dims, self.k, self.k2, self.L, t.nb_max, self.scale,
            t.cent, t.caux, t.valid, t.blk_rows, t.blk_aux, t.blk_slots, t.blk_scale,
            idx.rows, idx.norms, idx.extras, idx.slot_to_id,
            qv, qn, qe,
            fmask=self.fmask,
        )


def make_probe_fn(
    idx,
    state,
    count: int,
    search_k: int,
    n_trees: int | str = "auto",
    block: int | str = "auto",
    dtype: str = "auto",
    filter_slots: np.ndarray | None = None,
) -> ProbeFn:
    """Bind a leaf-probe serving fn: ``fn(qv, qn, qe, qf) -> (ids, dists)``.

    ``search_k`` keeps arroy's candidate-budget semantics: the probe
    touches ``T·L·P ≈ search_k`` item slots (L = per-tree probed
    blocks).  ``filter_slots`` serves the roaring-∩ contract: gathered
    block slots are masked against the candidate set before they can
    reach the re-score (reference: src/reader.rs:354-360), and the
    probed-block budget scales with 1/selectivity.  Binary-quantized
    metrics serve natively: packed-word block tables scored by XOR
    popcount, which is ranking-exact for all three BQ distances.
    """
    if idx.metric.binary:
        dtype = "bq"  # native packed words — the only storage there is
    if dtype == "auto":
        dtype = os.environ.get("ARROY_PROBE_DTYPE", "auto")
    if dtype == "auto":
        dtype = auto_dtype(idx)
    if n_trees == "auto":
        n_trees = DEFAULT_TREES
    T = auto_trees(idx, dtype) if n_trees == "auto" else int(n_trees)
    T = max(1, min(T, len(idx.roots)))
    P = DEFAULT_BLOCK if block == "auto" else int(block)
    tabs = get_tables(idx, state, T, P, dtype)
    fmask = None
    sel = 1.0
    if filter_slots is not None:
        sel = max(len(filter_slots) / max(idx.n_items, 1), 1e-6)
        mask = np.zeros(idx.cap, bool)
        mask[np.asarray(filter_slots, np.int64)] = True
        fmask = torch.from_numpy(mask).to(idx.device)
    L = blocks_per_tree(T, P, tabs.fill, search_k, tabs.nb_max, sel)
    k = max(1, int(count))
    k2 = rescore_cut(
        k, search_k, T * L * P,
        sign_bits=dtype == "bq" and not idx.metric.binary,
        custom=idx.metric not in ALL_METRICS,
    )
    return ProbeFn(idx, tabs, k, int(k2), int(L), block_scale(idx.metric), fmask)
