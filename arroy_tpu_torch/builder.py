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
replay does.  Every random draw is the JAX package's threefry draw at
the same address (`prng`, `grow_streams`), so a seed grows the JAX
package's forest, node for node, on the CPU and on the card alike (up
to a margin that rounds to the other sign in another f32 order; the
committed goldens in `tests/snapshots/` hold it).  In streaming mode (a memory
budget) the item matrix stays on the host and each grow or routing call
uploads only the rows it names (`BuildContext.device_view`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import prng
from .metrics import Metric, fma32
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
#: the JAX package's lane-compaction floor (its `_COMPACT_MIN_LANES`): a
#: grow over at least twice this many lanes compacts its lane frame once
#: the active lanes fit half of it, renumbering segments and lanes, and
#: the threefry stream is addressed by those numbers
_STREAM_COMPACT_LANES = 1 << 18
#: the rest of the JAX grow's frame arithmetic, which says when that
#: compaction fires: the smallest frame, rungs raised to powers of four
#: below `_STREAM_POW4_BELOW`, the levels fused into one group
#: (compaction is checked between groups) and the group tables' bytes
_STREAM_FRAME_MIN = 8192
_STREAM_POW4_BELOW = 1 << 21
_STREAM_FUSE = 8
_STREAM_FUSE_TABLE_BYTES = 1 << 30


def _two_means_core(metric, dims, srows, sex, shn):
    """Two-means refinement over pre-gathered samples [G, 12, ...].

    Sample rows 0/1 seed the centroids, rows 2..11 refine them
    (reference: src/distance/mod.rs:126-223).  Both centroids ride one
    [2, G, ...] stack, so each step computes their distances, updates and
    header values in one call each (every op is per row, so the values
    are those of two separate calls); the samples' norms are taken once.
    Returns ``metric.finalize_split`` of the two centroids: (normals
    [G, sd], aux [G])."""
    tv = metric.tm_decode(srows, dims)  # [G, 12, dt] f32 training space
    c, ce = tv[:, :2].transpose(0, 1), sex[:, :2].T  # [2, G, dt], [2, G]
    if metric.tm_cosine:
        c, ce = metric.tm_normalize(c, ce)
    ch = metric.tm_init(c, ce)
    cnt = torch.ones(ce.shape, dtype=torch.float32, device=c.device)  # [2, G]
    ks, kes, khs = tv[:, 2:], sex[:, 2:], shn[:, 2:]
    if metric.tm_cosine:
        norms = metric.tm_norm(ks, kes)  # [G, 10]
        oks = ~(torch.isnan(norms) | (norms <= 0.0))
        kns = ks / torch.where(oks, norms, 1.0)[..., None]
    for t in range(_SAMPLES - 2):
        k, ke, kh = ks[:, t], kes[:, t], khs[:, t]
        d = cnt * metric.tm_nonbuilt(c, ce, ch, k, ke, kh)
        # on an EXACT tie neither centroid moves (reference: `if di < dj {p}
        # else if dj < di {q}`)
        upd = torch.stack([d[0] < d[1], d[1] < d[0]])
        if metric.tm_cosine:
            upd = upd & oks[:, t]
            k = kns[:, t]
        # XLA contracts p * ic + k / nrm into one fused multiply-add
        new = fma32(c, cnt[..., None], k) / (cnt[..., None] + 1.0)
        ch = torch.where(upd, metric.tm_init(new, ce), ch)
        c = torch.where(upd[..., None], new, c)
        cnt = cnt + upd.float()
    return metric.finalize_split(c[0], ce[0], c[1], ce[1])


def _sample_positions(ss, sl, seg_keys) -> torch.Tensor:
    """[S, A, 12] permutation positions of each split segment's two-means
    samples, drawn as the JAX package draws them: attempt ``a``'s key is
    ``fold_in(seg_key, a)``; ``kc, ks = split(key)``; two distinct seeds
    ``i = randint(kc, 0, max(len, 2))`` and ``j = randint(fold_in(kc, 1),
    0, max(len, 2) - 1)`` (+1 where ``j >= i``), then ten refinement draws
    ``randint(ks, (10,), 0, max(len, 2))``, each clamped into the segment
    [ss, ss + sl).  The twelve randints share one split and one call for
    their words, so a level costs seven dependent threefry calls."""
    dev = ss.device
    att = prng.fold_in(seg_keys[:, None, :], torch.arange(_ATTEMPTS, device=dev))  # [S, A, 2]
    kc, ks = prng.split(att).unbind(-2)
    keys = prng.split(torch.stack([kc, prng.fold_in(kc, 1), ks], dim=-2))  # [S, A, 3, 2, 2]
    # draw d reads the split of kc, fold_in(kc, 1), ks, ks, ... at counter
    # 0, 0, 0, 1, ..., 9
    keys = torch.cat([keys[:, :, :2], keys[:, :, 2:].expand(-1, -1, _SAMPLES - 2, -1, -1)], dim=2)
    at = torch.clamp(torch.arange(-2, _SAMPLES - 2, device=dev), min=0)
    words = prng.bits_at(keys, at[:, None])  # [S, A, 12, 2]: each draw's high and low word
    ln = torch.clamp(sl, min=2)[:, None, None]
    span = torch.cat([ln, ln - 1, ln.expand(-1, -1, _SAMPLES - 2)], dim=-1)  # [S, 1, 12]
    idx = prng.randint_words(words[..., 0], words[..., 1], 0, span)
    i, j = idx[..., 0], idx[..., 1]
    idx[..., 1] = torch.where(j >= i, j + 1, j)
    hi = torch.clamp(sl - 1, min=0)[:, None, None]
    return ss[:, None, None] + torch.minimum(idx, hi)


def _two_means(metric, dims, rows, extras, hnorms, perm, ss, sl, seg_keys):
    """Two-means for every split segment x attempt: ([S, A, sd], [S, A])."""
    pos = _sample_positions(ss, sl, seg_keys)
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


def _level(metric, dims, rows, extras, hnorms, perm, ss, sl, level_keys, gids, fstart):
    """One build level over the split segments (starts `ss`, lengths `sl`,
    ascending and disjoint).  Each segment's draws come from its stream's
    ``level_keys`` [S, 2], its index ``gids`` [S] in the stream's frontier
    list and its first lane ``fstart`` [S] in the stream's lane frame.
    Partitions `perm` in place and returns (left counts [S],
    random-fallback flags [S], normals [S, sd], aux [S])."""
    s = ss.shape[0]
    dev = perm.device
    seg_keys = prng.fold_in(level_keys, gids)
    normals_a, aux_a = _two_means(metric, dims, rows, extras, hnorms, perm, ss, sl, seg_keys)

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

    # random-split fallback past 0.99 imbalance: the JAX package's
    # bernoulli(fold_in(level_key, 0x5EED), 0.5) at each lane's frame
    # position, drawn for the lanes of fallback segments only
    none = _imbalance(left_cnt, sl) > 0.99
    if bool(none.any()):
        lanes = torch.nonzero(none[cseg]).squeeze(1)
        seg = cseg[lanes]
        fb_keys = prng.fold_in(level_keys[seg], 0x5EED)
        right[lanes] = prng.bernoulli_at(fb_keys, fstart[seg] + (lanes - first[seg]))
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


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _next_rung(n: int) -> int:
    """The JAX grow's frame rung: a power of two, raised to a power of four
    below `_STREAM_POW4_BELOW`."""
    p = _next_pow2(n)
    if p < _STREAM_POW4_BELOW and (p.bit_length() - 1) % 2:
        p *= 2
    return p


class _Frame:
    """When the JAX package's grow compacts one stream's lane frame.

    That grow fuses up to `_STREAM_FUSE` levels into one dispatch, sized
    by its segment capacity ``g_cap`` and the byte budget of the fused
    tables, and checks between two such groups whether the active lanes
    fit half the padded frame ``p_pad``; if so it moves them to the front
    and renumbers segments and lanes.  Only these integers decide it, so
    the port replays them without the layout they size
    (`arroy_tpu/builder.py` `grow_trees`)."""

    def __init__(self, total: int, n_seeds: int, split_after: int, sd_bytes: int):
        self.split_after = split_after
        self.sd_bytes = sd_bytes
        self.p_pad = max(_STREAM_FRAME_MIN, _next_pow2(total))
        self.g_cap = max(
            256,
            _next_pow2(4 * total // max(split_after, 1) + n_seeds + 64),
            _next_pow2(n_seeds + 1),
        )
        self.upload = True  # the next group sizes g_cap to the frontier
        self.left = 0  # levels left in the current group

    @property
    def live(self) -> bool:
        """Whether a compaction can still fire."""
        return self.p_pad >= 2 * _STREAM_COMPACT_LANES

    def begin_level(self, level: int, g: int, ns: int, lanes: int) -> None:
        """A level of the stream: ``g`` segments in its frontier, ``ns`` of
        them splitting over ``lanes`` lanes.  Opens a group if none is."""
        if self.left:
            return
        if self.upload or g + ns > self.g_cap:
            self.g_cap = max(self.g_cap, 256, _next_pow2(g + ns + 1))
            self.upload = False
        ns_hard = max(lanes // (self.split_after + 1), 1)
        k = min(_STREAM_FUSE, max(_MAX_LEVELS - level, 1))
        while k > 1:
            ns_bound = min(ns << (k - 1), ns_hard)
            new_bound = min((ns << k) - ns, k * ns_hard)
            rung = 256
            while rung < max(ns_bound, ns):
                rung *= 4
            rung = min(rung, self.g_cap)
            table = rung * 4 * self.sd_bytes + k * rung * (self.sd_bytes + 16)
            if g + new_bound <= self.g_cap and table <= _STREAM_FUSE_TABLE_BYTES:
                break
            k -= 1
        self.left = k

    def end_level(self, active: int) -> bool:
        """Close a level with ``active`` lanes still splitting: whether its
        group ends here with a compaction."""
        self.left -= 1
        return (
            self.left == 0
            and active > 0
            and self.live
            and max(_next_rung(active), _STREAM_FRAME_MIN) <= self.p_pad // 2
        )

    def compact(self, active: int, n_active: int) -> None:
        self.p_pad = max(_STREAM_FRAME_MIN, _next_rung(active))
        self.g_cap = max(256, _next_rung(4 * active // max(self.split_after, 1) + n_active + 64))
        self.upload = True


def grow_trees(ctx: BuildContext, seeds: list[tuple[int, np.ndarray]], key) -> None:
    """Grow subtrees for every (node_id, item_slots) seed, all at once,
    drawing from the threefry ``key`` (two 32-bit words) as the JAX
    package's `grow_trees` does.

    Each seed becomes the root of a recursive split structure written
    into ctx.forest.  Seeds that already fit in a descendant must be
    handled by the caller."""
    grow_streams(ctx, [(key, seeds)])


def grow_streams(ctx: BuildContext, streams: list[tuple[object, list]]) -> None:
    """Several `grow_trees` calls, each a (key, seeds) stream, in one
    level-synchronous pass: the same forest, node ids included, as the
    calls made one after the other.

    A stream draws as the JAX package's grow does: level ``l``'s key is
    ``fold_in(key, l)``; a split segment's key folds in its index in the
    stream's frontier list (every segment of the stream, settled ones too,
    children in their parent's place), and a fallback lane's coin is read
    at the lane's position in the stream's lane frame.  Both addresses
    follow the JAX grow's lane compaction (`_Frame`), though no lane moves
    here.  Node ids are handed out after the grow, stream by stream and
    level by level, in the order the separate calls would take them."""
    streams = [
        (prng.key_data(k), [(int(nid), np.asarray(s, np.int64)) for nid, s in seeds])
        for k, seeds in streams
    ]
    streams = [(k, seeds) for k, seeds in streams if seeds]
    if not streams:
        return
    dev = ctx.device
    n_streams = len(streams)
    # resident mode: the whole matrix and slots as they are; streaming
    # mode: this call's unique rows, uploaded, and local indices into them
    all_slots = np.concatenate([s for _, seeds in streams for _, s in seeds])
    rows, extras, hnorms, remap, slot_to_id = ctx.device_view(all_slots)
    perm = torch.from_numpy(remap(all_slots)).to(dev)
    stream_keys = prng.as_tensor(np.stack([k for k, _ in streams]), dev)

    # the frontier of every stream, stream after stream, each in its own
    # order: stream, start in `perm`, first lane in the stream's frame,
    # length, node (an id, or -1 - v for the v-th child grown here), split
    seg_stream = np.repeat(np.arange(n_streams), [len(seeds) for _, seeds in streams])
    seg_len = np.asarray([len(s) for _, seeds in streams for _, s in seeds], np.int64)
    seg_start = np.cumsum(seg_len) - seg_len
    totals = np.bincount(seg_stream, weights=seg_len, minlength=n_streams).astype(np.int64)
    seg_frame = seg_start - (np.cumsum(totals) - totals)[seg_stream]
    seg_node = np.asarray([nid for _, seeds in streams for nid, _ in seeds], np.int64)
    # split iff the segment holds more items than fit in a descendant
    seg_split = seg_len > ctx.split_after
    sd_bytes = ctx.metric.storage_dim(ctx.dims) * 4
    frames = {}
    for i, (_, seeds) in enumerate(streams):
        fr = _Frame(int(totals[i]), len(seeds), ctx.split_after, sd_bytes)
        if fr.live:
            frames[i] = fr

    # leaves as (node, start, length) arrays, and the splits: stream, parent, row
    settled = ~seg_split
    leaf_node, leaf_start, leaf_len = [seg_node[settled]], [seg_start[settled]], [seg_len[settled]]
    rec_stream, rec_parent, rec_row = [], [], []
    n_virtual = 0
    level = 0
    while seg_split.any():
        ctx.check_cancel()
        if level >= _MAX_LEVELS:
            leaf_node.append(seg_node[seg_split])
            leaf_start.append(seg_start[seg_split])
            leaf_len.append(seg_len[seg_split])
            ctx.valve_items += int(seg_len[seg_split].sum())
            break
        bounds = np.searchsorted(seg_stream, np.arange(n_streams + 1))
        split_idx = np.nonzero(seg_split)[0]
        ns = len(split_idx)
        sstream = seg_stream[split_idx]
        s_arr, ln_arr, f_arr = seg_start[split_idx], seg_len[split_idx], seg_frame[split_idx]
        for i, fr in frames.items():
            sp = seg_split[bounds[i] : bounds[i + 1]]
            if sp.any():
                lanes = int(seg_len[bounds[i] : bounds[i + 1]][sp].sum())
                fr.begin_level(level, int(bounds[i + 1] - bounds[i]), int(sp.sum()), lanes)

        sst = torch.from_numpy(sstream).to(dev)
        left_cnt, none, normals, aux = _level(
            ctx.metric, ctx.dims, rows, extras, hnorms, perm,
            torch.from_numpy(s_arr).to(dev), torch.from_numpy(ln_arr).to(dev),
            prng.fold_in(stream_keys, level)[sst],
            torch.from_numpy(split_idx - bounds[sstream]).to(dev), torch.from_numpy(f_arr).to(dev),
        )
        lc_arr = left_cnt.cpu().numpy().astype(np.int64)
        used_pos = np.nonzero(~none.cpu().numpy())[0]

        # split records: fallback splits carry no normal row
        row_of_split = np.full(ns, -1, np.int64)
        if len(used_pos):
            use_t = torch.from_numpy(used_pos).to(dev)
            base = ctx.stage_chunk(normals[use_t], aux[use_t].cpu().numpy())
            row_of_split[used_pos] = base + np.arange(len(used_pos))
        rec_stream.append(sstream)
        rec_parent.append(seg_node[split_idx])
        rec_row.append(row_of_split)
        ids = -1 - (n_virtual + np.arange(2 * ns, dtype=np.int64))  # [l0, r0, l1, r1, ...]
        n_virtual += 2 * ns

        def pairs(a, b):
            out = np.empty(2 * ns, np.int64)
            out[0::2], out[1::2] = a, b
            return out

        ch_start = pairs(s_arr, s_arr + lc_arr)
        ch_frame = pairs(f_arr, f_arr + lc_arr)
        ch_len = pairs(lc_arr, ln_arr - lc_arr)
        ch_split = ch_len > ctx.split_after

        # the next frontier: every split segment replaced in place by its
        # two children, finished segments carried over
        src = np.repeat(np.arange(len(seg_split)), np.where(seg_split, 2, 1))
        is_child = seg_split[src]
        child = np.zeros(len(src), np.int64)
        child[is_child] = np.arange(2 * ns)
        seg_stream = seg_stream[src]
        seg_start = np.where(is_child, ch_start[child], seg_start[src])
        seg_frame = np.where(is_child, ch_frame[child], seg_frame[src])
        seg_len = np.where(is_child, ch_len[child], seg_len[src])
        seg_node = np.where(is_child, ids[child], seg_node[src])
        seg_split = is_child & ch_split[child]

        leaf_node.append(ids[~ch_split])
        leaf_start.append(ch_start[~ch_split])
        leaf_len.append(ch_len[~ch_split])
        level += 1
        indexed_now = int(ch_len[~ch_split].sum())
        if indexed_now:
            ctx.on_items_indexed(indexed_now)

        # the JAX grow's lane compaction, checked between its fused groups
        compacting = [
            i for i in np.unique(sstream).tolist()
            if i in frames
            and frames[i].end_level(int(seg_len[(seg_stream == i) & seg_split].sum()))
        ]
        if compacting:
            comp = np.zeros(n_streams, bool)
            comp[compacting] = True
            keep = ~comp[seg_stream] | seg_split
            seg_stream, seg_start, seg_frame, seg_len, seg_node, seg_split = (
                a[keep] for a in (seg_stream, seg_start, seg_frame, seg_len, seg_node, seg_split)
            )
            for i in compacting:
                mine = np.nonzero(seg_stream == i)[0]
                seg_frame[mine] = np.cumsum(seg_len[mine]) - seg_len[mine]
                frames[i].compact(int(seg_len[mine].sum()), len(mine))
                if not frames[i].live:
                    del frames[i]

    # node ids, in the order the streams' own calls would take them
    leaf_node = np.concatenate(leaf_node)
    if rec_stream:
        order = np.argsort(np.concatenate(rec_stream), kind="stable")
        real = ctx.alloc.next_many(2 * len(order))
        vmap = np.empty(n_virtual, np.int64)
        vmap[2 * order], vmap[2 * order + 1] = real[0::2], real[1::2]

        def resolve(n):
            return np.where(n >= 0, n, vmap[np.maximum(-1 - n, 0)])

        ctx.forest.put_splits(
            resolve(np.concatenate(rec_parent)), vmap[0::2], vmap[1::2], np.concatenate(rec_row)
        )
        leaf_node = resolve(leaf_node)

    # bulk leaf write-back: the leaf spans (empty ones too) tile [0, total)
    starts = np.concatenate(leaf_start)
    ends = starts + np.concatenate(leaf_len)
    s_sorted, e_sorted = np.sort(starts), np.sort(ends)
    if s_sorted[0] != 0 or not np.array_equal(s_sorted[1:], e_sorted[:-1]):
        raise AssertionError("leaf spans must tile the permutation")
    spans = list(zip(leaf_node.tolist(), starts.tolist(), ends.tolist()))
    _writeback_leaves(ctx, slot_to_id, perm.cpu().numpy()[: int(ends.max())], spans)


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


def _route_leaves(
    metric, rows, extras, slots, node, kind, left, right, ptr, aux, normals, coin_key
):
    """Walk every (item slot, start node) lane to its leaf on the device.

    Each step gathers every lane's split normal, takes its margin with the
    metric's `margin` (the helper the grow's `_margins` uses) and goes
    right iff the margin's sign bit is clear, the rule `_level` uses; at a
    normal-less split (`KIND_SPLIT_NONE`) the side is the JAX package's
    coin, ``bernoulli(fold_in(coin_key, step))`` at the lane's position in
    the chunk (reference: src/writer.rs:1409-1416), drawn only when
    `coin_key` is given.  The host reads "any lane moving" before every
    block of `_ROUTE_BLOCK` steps, so lanes that start at leaves cost one
    check; steps past the last move change nothing, so the step count
    that keys the coins is the JAX walk's."""
    from .models.forest import KIND_SPLIT, KIND_SPLIT_NONE

    v = None
    lanes = torch.arange(node.shape[0], device=node.device)
    for step0 in range(0, _ROUTE_MAX_STEPS, _ROUTE_BLOCK):
        k = kind[node]
        if not bool(((k == KIND_SPLIT) | (k == KIND_SPLIT_NONE)).any()):
            break
        if v is None:  # the lanes' rows, gathered once some lane moves
            v = rows[slots]
            qf = extras[slots] if metric.has_extra else 1.0
        for step in range(step0, step0 + _ROUTE_BLOCK):
            k = kind[node]
            # a lane at a leaf reads some row and stays put (a leaf's ptr
            # may be stale after a collapse, or -1)
            nr = torch.clamp(ptr[node], 0, normals.shape[0] - 1)
            go_right = ~torch.signbit(metric.margin(normals[nr], aux[nr], v, qf))
            if coin_key is not None:
                coin = prng.bernoulli_at(prng.fold_in(coin_key, step), lanes)
                go_right = torch.where(k == KIND_SPLIT_NONE, coin, go_right)
            moving = (k == KIND_SPLIT) | (k == KIND_SPLIT_NONE)
            node = torch.where(moving, torch.where(go_right, right[node], left[node]), node)
    return node


def route_lanes(
    ctx: BuildContext,
    normals_matrix_dev: torch.Tensor,
    aux_lookup: np.ndarray,
    entries: list[tuple[int, np.ndarray]],
    key,
) -> tuple[np.ndarray, np.ndarray]:
    """Route item slots from `entries` (node id, slots) down to leaves:
    (leaf node id, slot) of every lane, in the order of `entries`.

    The split planes are rows of `normals_matrix_dev` (with `aux_lookup`),
    found through `ctx.forest.ptr`.  The walk runs on `ctx.device` in
    chunks of `_ROUTE_CHUNK` lanes, with cancel polled once a chunk.
    Coins at normal-less splits are the JAX package's threefry bits:
    chunk ``ci`` walks with ``fold_in(key, ci)`` (the reference draws
    `rng.gen::<bool>()` per item)."""
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
    coins = bool((f.kind == KIND_SPLIT_NONE).any())
    dest = []
    for ci, off in enumerate(range(0, len(all_slots), _ROUTE_CHUNK)):
        ctx.check_cancel()
        dest.append(
            _route_leaves(
                ctx.metric, rows, extras, slots_local[off : off + _ROUTE_CHUNK],
                starts[off : off + _ROUTE_CHUNK], kind, left, right, ptr, aux,
                normals_matrix_dev,
                prng.as_tensor(prng.fold_in(prng.key_data(key), ci), dev) if coins else None,
            )
        )
    return torch.cat(dest).cpu().numpy(), all_slots


def route_items(
    ctx: BuildContext,
    normals_matrix_dev: torch.Tensor,
    aux_lookup: np.ndarray,
    entries: list[tuple[int, np.ndarray]],
    key,
) -> dict[int, list[np.ndarray]]:
    """`route_lanes` grouped by leaf: leaf node id → list of the slot
    arrays routed there, leaves ascending (reference:
    insert_items_in_descendants_*, src/writer.rs:1398-1531)."""
    dest, all_slots = route_lanes(ctx, normals_matrix_dev, aux_lookup, entries, key)
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
