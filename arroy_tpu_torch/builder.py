"""Level-synchronous batched forest builder (PyTorch).

Counterpart of `arroy_tpu/builder.py`: the grow path and the routing of
items down frozen trees (`route_items`).  The reference builds each tree by a per-node recursion (reference:
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
deterministic for a given seed and device.  In streaming mode (a memory
budget) the item matrix stays on the host and each grow or routing call
uploads only the rows it names (`BuildContext.device_view`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

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
    #: the build device: every tensor of the grow and the routing lives here
    device: torch.device
    #: device item matrix [cap, sd], extras and header norms [cap]; None in
    #: streaming mode, where the matrix stays on the host and each call
    #: uploads the rows it needs (`device_view`)
    rows_dev: Optional[torch.Tensor]
    extras_dev: Optional[torch.Tensor]
    hnorms_dev: Optional[torch.Tensor]
    slot_to_id: np.ndarray  # [cap] int64, -1 for free slots
    forest: Forest
    alloc: NodeIdAllocator
    cancel: Callable[[], bool] = lambda: False
    #: memory budget as the most items one tree-building batch may hold
    budget_items: Optional[int] = None
    #: host copies, present only in streaming mode
    rows_np: Optional[np.ndarray] = None
    extras_np: Optional[np.ndarray] = None
    hnorms_np: Optional[np.ndarray] = None
    #: staged split-plane chunks: (matrix, rows) — numpy for committed
    #: rows, device tensors for freshly built levels (pulled at finalize)
    staging_normals: list = field(default_factory=list)
    staging_aux: list = field(default_factory=list)
    staging_rows: int = 0
    on_items_indexed: Callable[[int], None] = lambda n: None
    #: items written into oversized leaves by a safety valve (grow_trees'
    #: level cap, the budget mode's regrowth cap)
    valve_items: int = 0
    #: device staging cache: the chunks already concatenated on the device
    _staging_dev: Optional[torch.Tensor] = field(default=None, repr=False)
    _staging_dev_chunks: int = field(default=0, repr=False)
    #: sorted (ids, slots) lookup, built once per build on first use
    _slot_lut: Optional[tuple] = field(default=None, repr=False)

    def check_cancel(self) -> None:
        if self.cancel():
            from .errors import BuildCancelled

            raise BuildCancelled()

    @property
    def streaming(self) -> bool:
        return self.rows_dev is None

    def device_view(self, slots: np.ndarray):
        """(rows, extras, hnorms, remap, slot_to_id) for a subset of slots.

        Resident mode returns the whole device arrays, an identity remap
        and the store's slot → id map; streaming mode uploads exactly the
        unique rows `slots` names and returns a global → local remap and
        the ids of those local rows."""
        if not self.streaming:
            return (
                self.rows_dev,
                self.extras_dev,
                self.hnorms_dev,
                lambda g: np.asarray(g, np.int64),
                self.slot_to_id,
            )
        uniq = np.unique(np.asarray(slots, np.int64))
        rows = self.rows_np[uniq]
        if self.metric.binary:
            rows = rows.view(np.int32)
        rows, extras, hnorms = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (rows, self.extras_np[uniq], self.hnorms_np[uniq])
        )

        def remap(g):
            return np.searchsorted(uniq, np.asarray(g, np.int64))

        return rows, extras, hnorms, remap, self.slot_to_id[uniq]

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

    def staging_matrix_dev(self) -> torch.Tensor:
        """The staged normals on the device, cached incrementally: only the
        chunks staged since the last call are uploaded and appended (the
        budget mode calls this once a regrown node, and rebuilding the
        whole matrix each time would be quadratic traffic)."""
        sd = self.metric.storage_dim(self.dims)
        dtype = torch.int32 if self.metric.binary else torch.float32
        if not self.staging_normals:
            return torch.zeros((1, sd), dtype=dtype, device=self.device)

        def dev(m):
            if isinstance(m, np.ndarray):
                m = torch.from_numpy(m.view(np.int32) if self.metric.binary else m)
            return m.to(self.device)

        fresh = [dev(m) for m in self.staging_normals[self._staging_dev_chunks :]]
        if fresh:
            parts = ([] if self._staging_dev is None else [self._staging_dev]) + fresh
            self._staging_dev = parts[0] if len(parts) == 1 else torch.cat(parts)
            self._staging_dev_chunks = len(self.staging_normals)
        return self._staging_dev

    def ids_to_slots(self, ids: np.ndarray) -> np.ndarray:
        """Item ids → store slots through a sorted lookup built once.
        Raises on an id absent from the store instead of clamping it to a
        wrong slot (that would hide a corrupt index)."""
        if self._slot_lut is None:
            live = np.nonzero(self.slot_to_id >= 0)[0]
            order = np.argsort(self.slot_to_id[live])
            self._slot_lut = (self.slot_to_id[live][order], live[order])
        sorted_ids, sorted_slots = self._slot_lut
        ids64 = np.asarray(ids, np.int64)
        pos = np.minimum(np.searchsorted(sorted_ids, ids64), max(len(sorted_ids) - 1, 0))
        if len(sorted_ids) == 0 or not np.array_equal(sorted_ids[pos], ids64):
            raise KeyError("leaf references item ids absent from the store")
        return sorted_slots[pos]


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
    dev = ctx.device
    # resident mode: the whole matrix and slots as they are; streaming
    # mode: this call's unique rows, uploaded, and local indices into them
    all_slots = np.concatenate([s for _, s in seeds])
    rows, extras, hnorms, remap, slot_to_id = ctx.device_view(all_slots)
    perm = torch.from_numpy(remap(all_slots)).to(dev)
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
            ctx.valve_items += int(seg_len[seg_split].sum())
            break
        split_idx = np.nonzero(seg_split)[0]
        ns = len(split_idx)
        s_arr = seg_start[split_idx]
        ln_arr = seg_len[split_idx]
        left_cnt, none, normals, aux = _level(
            ctx.metric, ctx.dims, rows, extras, hnorms, perm,
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
        _writeback_leaves(ctx, slot_to_id, perm.cpu().numpy()[: ends[-1]], pending_leaves)


# ---------------------------------------------------------------------------
# routing: items down a frozen tree, for incremental inserts and the
# memory-budgeted build (reference: src/writer.rs:1398-1531)
# ---------------------------------------------------------------------------

#: lanes per routing call: the [chunk, sd] gathers stay ~0.4 GB at 768-d
_ROUTE_CHUNK = 1 << 17
#: no tree is deeper than this; a lane still splitting past it stays put
_ROUTE_MAX_STEPS = 512
#: routing steps between host checks of "any lane still moving": a lane
#: that reached its leaf stays put, so the steps past the last split are
#: no-ops, and one check a block keeps the walk from being launch-bound
_ROUTE_BLOCK = 8


def _route_leaves(metric, rows, extras, slots, node, kind, left, right, ptr, aux, normals, gen):
    """Walk every (item slot, start node) lane to its leaf on the device.

    Each step gathers every lane's split normal, takes its margin with the
    metric's `margin` (the helper the grow's `_margins` uses) and goes
    right iff the margin's sign bit is clear, the rule `_level` uses; at a
    normal-less split (`KIND_SPLIT_NONE`) the side is a coin from `gen`
    (reference: src/writer.rs:1409-1416), drawn only when `gen` is given.
    The host reads "any lane moving" before every block of `_ROUTE_BLOCK`
    steps, so lanes that start at leaves cost one check."""
    from .models.forest import KIND_SPLIT, KIND_SPLIT_NONE

    v = None
    for _ in range(0, _ROUTE_MAX_STEPS, _ROUTE_BLOCK):
        k = kind[node]
        if not bool(((k == KIND_SPLIT) | (k == KIND_SPLIT_NONE)).any()):
            break
        if v is None:  # the lanes' rows, gathered once some lane moves
            v = rows[slots]
            qf = extras[slots] if metric.has_extra else 1.0
        for _ in range(_ROUTE_BLOCK):
            k = kind[node]
            # a lane at a leaf reads some row and stays put (a leaf's ptr
            # may be stale after a collapse, or -1)
            nr = torch.clamp(ptr[node], 0, normals.shape[0] - 1)
            go_right = ~torch.signbit(metric.margin(normals[nr], aux[nr], v, qf))
            if gen is not None:
                coin = torch.rand(node.shape, generator=gen, device=node.device) < 0.5
                go_right = torch.where(k == KIND_SPLIT_NONE, coin, go_right)
            moving = (k == KIND_SPLIT) | (k == KIND_SPLIT_NONE)
            node = torch.where(moving, torch.where(go_right, right[node], left[node]), node)
    return node


def route_lanes(
    ctx: BuildContext,
    normals_matrix_dev: torch.Tensor,
    aux_lookup: np.ndarray,
    entries: list[tuple[int, np.ndarray]],
    gen: torch.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Route item slots from `entries` (node id, slots) down to leaves:
    (leaf node id, slot) of every lane, in the order of `entries`.

    The split planes are rows of `normals_matrix_dev` (with `aux_lookup`),
    found through `ctx.forest.ptr`.  The walk runs on `ctx.device` in
    chunks of `_ROUTE_CHUNK` lanes, with cancel polled once a chunk.
    Coins at normal-less splits come from `gen` (the reference draws
    `rng.gen::<bool>()` per item; the JAX package draws threefry bits)."""
    from .models.forest import KIND_SPLIT_NONE

    f = ctx.forest
    entries = [(int(nid), np.asarray(s, dtype=np.int64)) for nid, s in entries if len(s)]
    if not entries:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    all_slots = np.concatenate([s for _, s in entries])
    starts = np.concatenate([np.full(len(s), nid, np.int64) for nid, s in entries])
    rows, extras, _, remap, _ = ctx.device_view(all_slots)
    dev = ctx.device
    slots_local = torch.from_numpy(remap(all_slots)).to(dev)
    starts = torch.from_numpy(starts).to(dev)
    kind, left, right, ptr = (
        torch.from_numpy(np.asarray(a, np.int64)).to(dev)
        for a in (f.kind, f.left, f.right, f.ptr)
    )
    if not len(aux_lookup):  # a forest of leaves: no plane is ever read
        aux_lookup = np.zeros(1, np.float32)
    aux = torch.from_numpy(np.asarray(aux_lookup, np.float32)).to(dev)
    coins = gen if bool((f.kind == KIND_SPLIT_NONE).any()) else None
    dest = []
    for off in range(0, len(all_slots), _ROUTE_CHUNK):
        ctx.check_cancel()
        dest.append(
            _route_leaves(
                ctx.metric, rows, extras, slots_local[off : off + _ROUTE_CHUNK],
                starts[off : off + _ROUTE_CHUNK], kind, left, right, ptr, aux,
                normals_matrix_dev, coins,
            )
        )
    return torch.cat(dest).cpu().numpy(), all_slots


def route_items(
    ctx: BuildContext,
    normals_matrix_dev: torch.Tensor,
    aux_lookup: np.ndarray,
    entries: list[tuple[int, np.ndarray]],
    gen: torch.Generator,
) -> dict[int, list[np.ndarray]]:
    """`route_lanes` grouped by leaf: leaf node id → list of the slot
    arrays routed there, leaves ascending (reference:
    insert_items_in_descendants_*, src/writer.rs:1398-1531)."""
    dest, all_slots = route_lanes(ctx, normals_matrix_dev, aux_lookup, entries, gen)
    if not len(dest):
        return {}
    order = np.argsort(dest, kind="stable")
    sdest, sslots = dest[order], all_slots[order]
    cuts = np.nonzero(np.diff(sdest))[0] + 1
    heads = sdest[np.concatenate([[0], cuts]).astype(np.int64)]
    collected: dict[int, list[np.ndarray]] = {}
    for nid, g in zip(heads, np.split(sslots, cuts)):
        collected.setdefault(int(nid), []).append(g)
    return collected
