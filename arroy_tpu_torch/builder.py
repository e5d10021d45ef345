"""Level-synchronous batched forest builder (PyTorch).

Counterpart of the full-build grow path of `arroy_tpu/builder.py`.  The
reference builds each tree by a per-node recursion (reference:
src/writer.rs:1167-1261, src/distance/mod.rs:126-171); here one plain
per-level loop grows **every splitting node of every tree at once**,
over tensors on the build device:

1. two-means for every splitting segment x 4 imbalance-retry attempts
   (10 refinement steps over 12 sampled items each);
2. the margin of every item of those segments against each attempt's
   hyperplane, in lane chunks that bound the gathered-normals temporary;
3. per segment the FIRST attempt under 0.95 imbalance wins (else the
   last), and a random side per item past 0.99 imbalance (reference
   src/writer.rs:1209-1233);
4. a stable within-segment partition (left items first) of the slot
   permutation.

The host keeps the segment bookkeeping in numpy and allocates node ids,
records splits and writes leaves back, exactly as the JAX builder's host
replay does.  Randomness comes from one explicit `torch.Generator`, so
forests differ from the JAX package's threefry streams but are
deterministic for a given seed and device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .metrics import Metric
from .models.forest import Forest, NodeIdAllocator
from .ops.binary import words_to_host

#: safety valve: no real forest is deeper than this; past it the remaining
#: segments are written as oversized descendants instead of looping forever
_MAX_LEVELS = 200
#: imbalance-retry attempts per split segment
_ATTEMPTS = 4
#: two-means samples per (segment, attempt): 2 seeds + 10 refinement draws
_SAMPLES = 12
#: byte budget of one temporary in the two-means and margin passes
_CHUNK_BYTES = 256 << 20


def _two_means_core(metric, dims, srows, sex, shn):
    """Two-means refinement over pre-gathered samples [G, 12, ...].

    Sample rows 0/1 seed the centroids, rows 2..11 refine them
    (reference: src/distance/mod.rs:126-223).  Returns
    ``metric.finalize_split`` of the two centroids: (normals [G, sd],
    aux [G])."""
    tv = metric.tm_decode(srows, dims)  # [G, 12, dt] f32 training space
    p, q = tv[:, 0], tv[:, 1]
    pe, qe = sex[:, 0], sex[:, 1]
    if metric.tm_cosine:
        p, pe = metric.tm_normalize(p, pe)
        q, qe = metric.tm_normalize(q, qe)
    ph = metric.tm_init(p, pe)
    qh = metric.tm_init(q, qe)
    ic = torch.ones(p.shape[0], dtype=torch.float32, device=p.device)
    jc = torch.ones_like(ic)
    for t in range(2, _SAMPLES):
        k, ke, kh = tv[:, t], sex[:, t], shn[:, t]
        di = ic * metric.tm_nonbuilt(p, pe, ph, k, ke, kh)
        dj = jc * metric.tm_nonbuilt(q, qe, qh, k, ke, kh)
        norm = metric.tm_norm(k, ke) if metric.tm_cosine else torch.ones_like(di)
        ok = ~(torch.isnan(norm) | (norm <= 0.0))
        nrm = torch.where(ok, norm, 1.0)[:, None]
        # on an EXACT tie neither centroid moves (reference: `if di < dj {p}
        # else if dj < di {q}`)
        updp = ok & (di < dj)
        updq = ok & (dj < di)
        newp = (p * ic[:, None] + k / nrm) / (ic[:, None] + 1.0)
        newq = (q * jc[:, None] + k / nrm) / (jc[:, None] + 1.0)
        ph = torch.where(updp, metric.tm_init(newp, pe), ph)
        qh = torch.where(updq, metric.tm_init(newq, qe), qh)
        p = torch.where(updp[:, None], newp, p)
        q = torch.where(updq[:, None], newq, q)
        ic = ic + updp.float()
        jc = jc + updq.float()
    return metric.finalize_split(p, pe, q, qe)


def _sample_positions(ss, sl, gen) -> torch.Tensor:
    """[S, A, 12] permutation positions: two distinct seeds + 10 draws,
    uniform within each segment [ss, ss + sl)."""
    u = torch.rand(
        (ss.shape[0], _ATTEMPTS, _SAMPLES), generator=gen, dtype=torch.float64,
        device=ss.device,
    )
    ln = torch.clamp(sl, min=2).double()[:, None]
    i = torch.floor(u[..., 0] * ln)
    j = torch.floor(u[..., 1] * (ln - 1.0))
    j = torch.where(j >= i, j + 1.0, j)
    rest = torch.floor(u[..., 2:] * ln[..., None])
    idx = torch.cat([i[..., None], j[..., None], rest], dim=-1).long()
    hi = torch.clamp(sl - 1, min=0)[:, None, None]
    return ss[:, None, None] + torch.minimum(idx, hi)


def _two_means(metric, dims, rows, extras, hnorms, perm, ss, sl, gen):
    """Two-means for every split segment x attempt: ([S, A, sd], [S, A])."""
    pos = _sample_positions(ss, sl, gen)
    slots = perm[pos]  # [S, A, 12]
    s = slots.shape[0]
    tm_bytes = _ATTEMPTS * _SAMPLES * metric.tm_dim(dims) * 4 * 4
    step = max(_CHUNK_BYTES // tm_bytes, 1)
    normals, aux = [], []
    for c in range(0, s, step):
        sc = slots[c : c + step].reshape(-1, _SAMPLES)
        n, a = _two_means_core(metric, dims, rows[sc], extras[sc], hnorms[sc])
        normals.append(n)
        aux.append(a)
    sd = rows.shape[1]
    return (
        torch.cat(normals).reshape(s, _ATTEMPTS, sd),
        torch.cat(aux).reshape(s, _ATTEMPTS),
    )


def _margins(metric, rows, extras, slots, cseg, normals, aux):
    """[L, A] margins of every split lane against each attempt's plane."""
    sd = rows.shape[1]
    step = max(_CHUNK_BYTES // (_ATTEMPTS * sd * 8), 1)
    out = []
    for c in range(0, slots.shape[0], step):
        sl = slots[c : c + step]
        sg = cseg[c : c + step]
        v = rows[sl][:, None, :]  # [C, 1, sd]
        base = metric.base_dot(normals[sg], v)  # [C, A]
        qf = extras[sl][:, None] if metric.has_extra else 1.0
        out.append(base + aux[sg] * qf)
    return torch.cat(out)


def _segment_counts(flags: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of [..., L] int flags over contiguous spans `lens`."""
    cs = torch.cumsum(flags, dim=-1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    ends = torch.cumsum(lens, dim=0)
    return cs[..., ends] - cs[..., ends - lens]


def _imbalance(left: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    nf = n.float()
    f = torch.where(n > 0, left.float() / torch.where(n > 0, nf, 1.0), 0.5)
    return torch.maximum(f, 1.0 - f)


def _level(metric, dims, rows, extras, hnorms, perm, ss, sl, gen):
    """One build level over the split segments (starts `ss`, lengths `sl`,
    ascending and disjoint).  Partitions `perm` in place and returns
    (left counts [S], random-fallback flags [S], normals [S, sd], aux [S])."""
    s = ss.shape[0]
    dev = perm.device
    normals_a, aux_a = _two_means(metric, dims, rows, extras, hnorms, perm, ss, sl, gen)

    # lanes of the split segments, segment-major and ascending
    cseg = torch.repeat_interleave(torch.arange(s, device=dev), sl)
    first = torch.cumsum(sl, dim=0) - sl
    lane_pos = ss[cseg] + (torch.arange(cseg.shape[0], device=dev) - first[cseg])
    slots = perm[lane_pos]
    margins = _margins(metric, rows, extras, slots, cseg, normals_a, aux_a)  # [L, A]

    left_a = torch.signbit(margins).T.long()  # [A, L]; sign bit set == left
    cnt_a = _segment_counts(left_a, sl)  # [A, S]
    settled = _imbalance(cnt_a, sl[None, :]) < 0.95
    sel = torch.where(
        settled.any(dim=0), torch.argmax(settled.int(), dim=0), _ATTEMPTS - 1
    )  # first attempt under 0.95 wins
    ar = torch.arange(s, device=dev)
    normals = normals_a[ar, sel]
    aux = aux_a[ar, sel]
    left_cnt = cnt_a[sel, ar]
    right = ~torch.signbit(margins[torch.arange(cseg.shape[0], device=dev), sel[cseg]])

    # random-split fallback past 0.99 imbalance
    none = _imbalance(left_cnt, sl) > 0.99
    if bool(none.any()):
        rnd = torch.rand(cseg.shape[0], generator=gen, device=dev) < 0.5
        right = torch.where(none[cseg], rnd, right)
        left_cnt = torch.where(none, _segment_counts((~right).long(), sl), left_cnt)

    # stable within-segment partition: left lanes first
    order = torch.sort(cseg * 2 + right.long(), stable=True).indices
    perm[lane_pos] = slots[order]
    return left_cnt, none, normals, aux


@dataclass
class BuildContext:
    """Everything the build engine needs for one index build."""

    metric: type[Metric]
    dims: int
    split_after: int
    #: device item matrix [cap, sd], extras and header norms [cap]
    rows_dev: torch.Tensor
    extras_dev: torch.Tensor
    hnorms_dev: torch.Tensor
    slot_to_id: np.ndarray  # [cap] int64, -1 for free slots
    forest: Forest
    alloc: NodeIdAllocator
    cancel: Callable[[], bool] = lambda: False
    #: staged split-plane chunks: (matrix, rows) — numpy for committed
    #: rows, device tensors for freshly built levels (pulled at finalize)
    staging_normals: list = field(default_factory=list)
    staging_aux: list = field(default_factory=list)
    staging_rows: int = 0
    on_items_indexed: Callable[[int], None] = lambda n: None

    def check_cancel(self) -> None:
        if self.cancel():
            from .errors import BuildCancelled

            raise BuildCancelled()

    def stage_chunk(self, matrix, aux: np.ndarray) -> int:
        """Append a chunk of normal rows; returns its base row index."""
        base = self.staging_rows
        self.staging_normals.append(matrix)
        self.staging_aux.append(np.asarray(aux, np.float32))
        self.staging_rows += int(matrix.shape[0])
        return base

    def staging_matrix_np(self) -> np.ndarray:
        sd = self.metric.storage_dim(self.dims)
        np_dtype = np.uint32 if self.metric.binary else np.float32
        if not self.staging_normals:
            return np.zeros((0, sd), np_dtype)
        parts = []
        for m in self.staging_normals:
            if isinstance(m, torch.Tensor):
                m = words_to_host(m) if self.metric.binary else m.cpu().numpy()
            parts.append(np.asarray(m, np_dtype))
        return np.concatenate(parts)

    def staging_aux_np(self) -> np.ndarray:
        if not self.staging_aux:
            return np.zeros(0, np.float32)
        return np.concatenate(self.staging_aux)


def _writeback_leaves(ctx, slot_to_id, vals_np, spans) -> None:
    """Bulk leaf write-back: `spans` is a list of (node_id, start, end)
    whose lanes, concatenated in ascending-start order, are exactly
    `vals_np` (slots).  One lexsort over all lanes."""
    if not spans:
        return
    nids = np.fromiter((p[0] for p in spans), np.int64, len(spans))
    starts = np.fromiter((p[1] for p in spans), np.int64, len(spans))
    ends = np.fromiter((p[2] for p in spans), np.int64, len(spans))
    order = np.argsort(starts, kind="stable")
    nids = nids[order]
    lens = (ends - starts)[order]
    if int(lens.sum()) != len(vals_np):
        raise AssertionError("leaf spans must tile the written lanes")
    ids_all = slot_to_id[vals_np].astype(np.uint32)
    span_of = np.repeat(np.arange(len(nids), dtype=np.int64), lens)
    sorted_ids = ids_all[np.lexsort((ids_all, span_of))]
    pieces = np.split(sorted_ids, np.cumsum(lens)[:-1])
    ctx.forest.put_leaves(nids, pieces)


def grow_trees(ctx: BuildContext, seeds: list[tuple[int, np.ndarray]], gen: torch.Generator) -> None:
    """Grow subtrees for every (node_id, item_slots) seed, all at once.

    Each seed becomes the root of a recursive split structure written
    into ctx.forest.  Seeds that already fit in a descendant must be
    handled by the caller."""
    seeds = [(nid, np.asarray(slots, dtype=np.int64)) for nid, slots in seeds]
    if not seeds:
        return
    dev = ctx.rows_dev.device
    perm = torch.from_numpy(np.concatenate([s for _, s in seeds])).to(dev)
    seg_len = np.asarray([len(s) for _, s in seeds], np.int64)
    seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]]).astype(np.int64)
    seg_node = np.asarray([nid for nid, _ in seeds], np.int64)
    # split iff the segment holds more items than fit in a descendant
    seg_split = seg_len > ctx.split_after

    pending_leaves: list[tuple[int, int, int]] = [
        (int(seg_node[g]), int(seg_start[g]), int(seg_start[g] + seg_len[g]))
        for g in np.nonzero(~seg_split)[0]
    ]
    level = 0
    while seg_split.any():
        ctx.check_cancel()
        if level >= _MAX_LEVELS:
            for g in np.nonzero(seg_split)[0]:
                pending_leaves.append(
                    (int(seg_node[g]), int(seg_start[g]), int(seg_start[g] + seg_len[g]))
                )
            break
        split_idx = np.nonzero(seg_split)[0]
        ns = len(split_idx)
        s_arr = seg_start[split_idx]
        ln_arr = seg_len[split_idx]
        left_cnt, none, normals, aux = _level(
            ctx.metric, ctx.dims, ctx.rows_dev, ctx.extras_dev, ctx.hnorms_dev, perm,
            torch.from_numpy(s_arr).to(dev), torch.from_numpy(ln_arr).to(dev), gen,
        )
        lc_arr = left_cnt.cpu().numpy().astype(np.int64)
        use = ~none.cpu().numpy()
        used_pos = np.nonzero(use)[0]

        # split records: fallback splits carry no normal row
        row_of_split = np.full(ns, -1, np.int64)
        if len(used_pos):
            use_t = torch.from_numpy(used_pos).to(dev)
            base = ctx.stage_chunk(normals[use_t], aux[use_t].cpu().numpy())
            row_of_split[used_pos] = base + np.arange(len(used_pos))
        ids = ctx.alloc.next_many(2 * ns)  # [l0, r0, l1, r1, ...]
        l_ids, r_ids = ids[0::2], ids[1::2]
        ctx.forest.put_splits(seg_node[split_idx], l_ids, r_ids, row_of_split)

        ch_start = np.empty(2 * ns, np.int64)
        ch_start[0::2] = s_arr
        ch_start[1::2] = s_arr + lc_arr
        ch_len = np.empty(2 * ns, np.int64)
        ch_len[0::2] = lc_arr
        ch_len[1::2] = ln_arr - lc_arr
        ch_split = ch_len > ctx.split_after

        # the next frontier: every split segment replaced in place by its
        # two children, finished segments carried over
        counts = np.where(seg_split, 2, 1)
        pos = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        total_out = int(counts.sum())
        new_start = np.empty(total_out, np.int64)
        new_len = np.empty(total_out, np.int64)
        new_node = np.empty(total_out, np.int64)
        new_split = np.zeros(total_out, bool)
        keep = ~seg_split
        new_start[pos[keep]] = seg_start[keep]
        new_len[pos[keep]] = seg_len[keep]
        new_node[pos[keep]] = seg_node[keep]
        ppos = pos[split_idx]
        new_start[ppos] = ch_start[0::2]
        new_start[ppos + 1] = ch_start[1::2]
        new_len[ppos] = ch_len[0::2]
        new_len[ppos + 1] = ch_len[1::2]
        new_node[ppos] = l_ids
        new_node[ppos + 1] = r_ids
        new_split[ppos] = ch_split[0::2]
        new_split[ppos + 1] = ch_split[1::2]

        leaf_children = np.nonzero(~ch_split)[0]
        for j in leaf_children.tolist():
            pending_leaves.append(
                (int(ids[j]), int(ch_start[j]), int(ch_start[j] + ch_len[j]))
            )
        seg_start, seg_len, seg_node, seg_split = new_start, new_len, new_node, new_split
        level += 1
        indexed_now = int(ch_len[leaf_children].sum())
        if indexed_now:
            ctx.on_items_indexed(indexed_now)

    # bulk leaf write-back: the pending spans tile [0, total) exactly
    if pending_leaves:
        starts = np.sort(np.fromiter((p[1] for p in pending_leaves), np.int64))
        ends = np.sort(np.fromiter((p[2] for p in pending_leaves), np.int64))
        if starts[0] != 0 or not np.all(starts[1:] == ends[:-1]):
            raise AssertionError("pending leaf spans must tile the permutation")
        _writeback_leaves(ctx, ctx.slot_to_id, perm.cpu().numpy()[: ends[-1]], pending_leaves)
