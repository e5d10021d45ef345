"""Multi-device build: ONE forest grown over a mesh-sharded corpus.

Counterpart of `arroy_tpu/parallel/build.py`, and the same algorithm.
The single-device grow (`builder.grow_trees`) keeps one permutation and
partitions it each level.  Across devices that would move the corpus
every level, so the sharded grow is label-synchronous instead: **items
never move**.  Item rows are split contiguously over the mesh and stay
put; each (seed, item) entry carries a dense segment label, rewritten
locally each level:

1. **sample**: two-means samples are drawn per segment by a hashed
   segmented argmax (12 draws; the centroid pair is forced distinct),
   merged across shards by a max, and each winner's row is fetched from
   the shard that owns it;
2. **two-means**: the port's `builder._two_means_core` over the [G, 12]
   samples of the G splitting segments, once, on ``devices[0]``;
3. **margins / side**: local to each shard; per-segment left counts are
   summed across shards; the imbalance retries (accept < 0.95, 4
   attempts, a random side past 0.99; reference: src/writer.rs:1209-1233)
   run as in the single-device grow;
4. **relabel**: ``new = side ? right_tab[seg] : left_tab[seg]``, a local
   gather; the dense renumbering tables come from the host.

Every cross-shard reduction is an integer max or sum, the winners' rows
are copied (not summed) from their shard, the two-means sees the same
[G, 12] samples for any mesh, and each margin is computed in row chunks
of one fixed shape (`_entry_margins`), so its reduction order does not
depend on how many rows a shard holds.  The built forest is therefore
**bit-identical for any mesh size**.  The hash stream is the JAX
package's bit for bit (`_mix`, 32-bit words kept in int64 tensors), and
its 32-bit ``seed_base`` the JAX package's (the last word of the build
key), so the forest equals its sharded forest up to the last bit of f32
arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..builder import _MAX_LEVELS, BuildContext, _two_means_core

_MASK32 = 0xFFFFFFFF
_INT32_MIN = -(1 << 31)
#: margin entries computed in one chunk (padded to it): one fixed shape
#: for every call keeps each row's reduction order independent of the
#: shard size; ~48 MB of gathered f32 rows at 768-d
_MARGIN_ENTRIES = 1 << 14


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for 32-bit words held in int64: the constant is
    split into 16-bit halves, so no product passes 2**49."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer (murmur3-style avalanche), the JAX
    package's `_mix` on words held in int64 tensors."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix_host(x: int) -> int:
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _MASK32
    x ^= x >> 16
    return x


def _entry_margins(metric, rows, extras, row_of, seg_of, normals, aux):
    """Margin of each entry: row ``row_of[e]`` against the plane
    ``normals[seg_of[e]]`` (``aux`` its offset), in chunks of exactly
    `_MARGIN_ENTRIES` entries (the last padded), so that every call runs
    the same reduction on the same shape."""
    n_e = int(row_of.shape[0])
    out = torch.empty(n_e, dtype=torch.float32, device=rows.device)
    for s in range(0, n_e, _MARGIN_ENTRIES):
        e = min(s + _MARGIN_ENTRIES, n_e)
        pad = _MARGIN_ENTRIES - (e - s)
        r = torch.nn.functional.pad(row_of[s:e], (0, pad))
        g = torch.nn.functional.pad(seg_of[s:e], (0, pad))
        qf = extras[r] if metric.has_extra else 1.0
        out[s:e] = (metric.base_dot(normals[g], rows[r]) + aux[g] * qf)[: e - s]
    return out


def _imbalance(lc: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    nl = lens.to(torch.float32)
    f = torch.where(lens > 0, lc.to(torch.float32) / torch.where(lens > 0, nl, 1.0), 0.5)
    return torch.maximum(f, 1.0 - f)


class _Shard:
    """One shard's rows and its labels, on its device."""

    def __init__(self, rows, extras, hnorms, seg, off: int, n_seeds: int, device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.device = device
        self.rows = t(rows.view(np.int32) if rows.dtype == np.uint32 else rows)
        self.extras, self.hnorms = t(extras), t(hnorms)
        self.seg = t(seg.astype(np.int64))  # [S, m_l]
        m_l = self.rows.shape[0]
        self.off = off
        self.ig = off + torch.arange(m_l, device=device)  # global slots
        salt = (np.arange(n_seeds, dtype=np.int64) * 0x9E3779B9) & _MASK32
        # per-entry hash base: seed salt + global slot, mod 2**32
        self.gid = (t(salt)[:, None] + self.ig[None, :]) & _MASK32


def _level_step(metric, dims, g, shards, dev0, lens, split, ltab, rtab, ktab, salt):
    """One sharded build level over the ``g`` current segments (host
    tables ``lens``, ``split``, ``ltab``, ``rtab``, ``ktab`` [g]).  Relabels
    every shard's entries in place and returns (normals [G, sd] and aux
    [G] of the G splitting segments in ascending order, left counts [g],
    random-fallback flags [g]) on ``dev0``."""
    split_ids = np.nonzero(split)[0]
    t0 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev0)  # noqa: E731
    lens_d, split_d = t0(lens.astype(np.int64)), t0(split)
    # per-shard tables and masks, made once a level
    local = []
    for sh in shards:
        split_l = split_d.to(sh.device)
        elig = (sh.seg > 0) & split_l[sh.seg]
        local.append(dict(split=split_l, elig=elig, segf=sh.seg.reshape(-1)))

    def segment_max(vals, seg_f):
        """Per-segment max (an empty segment keeps int32's minimum, as
        `jax.ops.segment_max` gives it)."""
        out = torch.full((g,), _INT32_MIN, dtype=torch.int64, device=vals.device)
        return out.scatter_reduce(0, seg_f, vals.reshape(-1), "amax", include_self=False)

    def global_max(parts):
        out = parts[0].to(dev0)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(dev0))
        return out

    def argmax_of(fields):
        """Per segment, the global slot of the entry with the largest
        positive value (the highest slot on a tie, as in the JAX package);
        < 0 if none."""
        mx = global_max([segment_max(v, loc["segf"]) for v, loc in zip(fields, local)])
        cands = []
        for v, sh, loc in zip(fields, shards, local):
            mx_l = mx.to(sh.device)
            c = torch.where((v == mx_l[sh.seg]) & (v > 0), sh.ig[None, :].expand_as(v), -1)
            cands.append(segment_max(c, loc["segf"]))
        return global_max(cands)

    def attempt(att: int):
        def field(j):
            add = (j * 0x85EBCA6B + att * 0xC2B2AE35) & _MASK32
            out = []
            for sh, loc in zip(shards, local):
                h = _mix(salt ^ _mix((sh.gid + add) & _MASK32))
                out.append(torch.where(loc["elig"], (h >> 1) | 1, 0))
            return out

        # the centroid pair forced distinct (reference choose_two,
        # src/parallel.rs:342-367); refinement draws are independent
        c1 = argmax_of(field(0))
        v1 = [torch.where(sh.ig[None, :] == c1.to(sh.device)[sh.seg], 0, v)
              for v, sh in zip(field(1), shards)]
        winners = [c1, argmax_of(v1)] + [argmax_of(field(j)) for j in range(2, 12)]
        w = torch.stack(winners)[:, torch.from_numpy(split_ids).to(dev0)]  # [12, G]
        # the winners' rows, copied from the shard that owns each
        sd = shards[0].rows.shape[1]
        srows = torch.zeros((12, len(split_ids), sd), dtype=shards[0].rows.dtype, device=dev0)
        sex = torch.zeros((12, len(split_ids)), dtype=torch.float32, device=dev0)
        shn = torch.zeros_like(sex)
        for sh in shards:
            loc = w.to(sh.device) - sh.off
            ok = (w.to(sh.device) >= 0) & (loc >= 0) & (loc < sh.rows.shape[0])
            if bool(ok.any()):
                li = loc[ok]
                ok0 = ok.to(dev0)
                srows[ok0] = sh.rows[li].to(dev0)
                sex[ok0] = sh.extras[li].to(dev0)
                shn[ok0] = sh.hnorms[li].to(dev0)
        normals, aux = _two_means_core(metric, dims, srows.transpose(0, 1), sex.T, shn.T)
        # margins of the eligible entries against their segment's plane
        compact = torch.full((g,), -1, dtype=torch.int64, device=dev0)
        compact[torch.from_numpy(split_ids).to(dev0)] = torch.arange(len(split_ids), device=dev0)
        sides, lc = [], torch.zeros(g, dtype=torch.int64, device=dev0)
        for sh, loc in zip(shards, local):
            e = torch.nonzero(loc["elig"].reshape(-1)).view(-1)
            row_of = e % sh.rows.shape[0]
            seg_e = loc["segf"][e]
            mg = _entry_margins(metric, sh.rows, sh.extras, row_of, compact.to(sh.device)[seg_e],
                                normals.to(sh.device), aux.to(sh.device))
            side = torch.zeros(loc["segf"].shape[0], dtype=torch.bool, device=sh.device)
            side[e] = ~torch.signbit(mg)
            side = side.view_as(sh.seg)
            lc += torch.bincount(seg_e[~side.reshape(-1)[e]], minlength=g).to(dev0)
            sides.append(side)
        return normals, aux, sides, lc

    normals, aux, sides, lc = attempt(0)
    settled = _imbalance(lc, lens_d) < 0.95
    att = 1
    while att < 4 and bool((split_d & ~settled).any()):
        n2, a2, s2, c2 = attempt(att)
        keep = settled[torch.from_numpy(split_ids).to(dev0)]
        normals = torch.where(keep[:, None], normals, n2)
        aux = torch.where(keep, aux, a2)
        sides = [torch.where(settled.to(sh.device)[sh.seg], s, s_new)
                 for s, s_new, sh in zip(sides, s2, shards)]
        lc = torch.where(settled, lc, c2)
        settled = settled | (_imbalance(lc, lens_d) < 0.95)
        att += 1

    # random-split fallback past 0.99 (reference src/writer.rs:1218-1233)
    none = split_d & (_imbalance(lc, lens_d) > 0.99)
    if bool(none.any()):
        lc2 = torch.zeros(g, dtype=torch.int64, device=dev0)
        for i, (sh, loc) in enumerate(zip(shards, local)):
            rnd = (_mix(salt ^ 0x5EED5EED ^ _mix(sh.gid)) & 1) == 1
            sides[i] = torch.where(none.to(sh.device)[sh.seg], rnd, sides[i])
            left = (~sides[i]) & loc["elig"]
            lc2 += torch.bincount(loc["segf"][left.reshape(-1)], minlength=g).to(dev0)
        lc = torch.where(none, lc2, lc)

    # relabel
    for sh, loc, side in zip(shards, local, sides):
        lt, rt, kt = (t0(a.astype(np.int64)).to(sh.device) for a in (ltab, rtab, ktab))
        s = sh.seg
        sh.seg = torch.where(loc["split"][s], torch.where(side, rt[s], lt[s]), kt[s])
    return normals, aux, lc, none


def grow_trees_sharded(ctx: BuildContext, seeds, key, mesh) -> None:
    """Sharded twin of `builder.grow_trees`: grow every oversized seed's
    subtree into ctx.forest, the per-level compute spread over the mesh.
    Needs the host item mirrors on ctx (``rows_np`` et al).

    The hash stream's 32-bit ``seed_base`` is the last word of the
    threefry ``key`` (the writer passes ``fold_in(key(seed), 0xB111D)``,
    as the JAX package's does)."""
    seeds = [(int(nid), np.asarray(slots, np.int64)) for nid, slots in seeds]
    if not seeds:
        return
    if ctx.rows_np is None:
        raise ValueError("the sharded build needs the host item mirrors")
    seed_base = int(prng.key_data(key)[-1])

    n = mesh.devices.size
    s_count = len(seeds)
    cap = int(ctx.rows_np.shape[0])
    m_l = -(-max(cap, 1) // n)
    m_pad = m_l * n

    def pad_rows(a):
        out = np.zeros((m_pad,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    # dense segment labels: 0 = dead, 1+s = seed s's root segment
    seg_np = np.zeros((s_count, m_pad), np.int64)
    lens = [0]
    node_of: dict[int, int] = {}
    for s, (nid, slots) in enumerate(seeds):
        seg_np[s, slots] = 1 + s
        node_of[1 + s] = nid
        lens.append(len(slots))
    lens = np.asarray(lens, np.int64)
    rows, extras, hnorms = (pad_rows(a) for a in (ctx.rows_np, ctx.extras_np, ctx.hnorms_np))
    shards = [
        _Shard(rows[s * m_l:(s + 1) * m_l], extras[s * m_l:(s + 1) * m_l],
               hnorms[s * m_l:(s + 1) * m_l], seg_np[:, s * m_l:(s + 1) * m_l], s * m_l,
               s_count, mesh.devices[s])
        for s in range(n)
    ]
    del seg_np
    dev0 = mesh.devices[0]

    level = 0
    flushed = False
    while True:
        g = len(lens)
        active = lens > ctx.split_after
        if not active.any():
            break
        if level >= _MAX_LEVELS:
            flushed = True  # leftover oversized segments become fat leaves
            break
        ctx.check_cancel()

        # dense renumbering for the next level (host tables)
        ltab = np.zeros(g, np.int64)
        rtab = np.zeros(g, np.int64)
        ktab = np.zeros(g, np.int64)
        c = 1
        kept: list[tuple[int, int]] = []  # (new_g, old_g)
        split_children: list[tuple[int, int, int]] = []  # (old_g, lg, rg)
        for gg in range(1, g):
            if active[gg]:
                ltab[gg], rtab[gg] = c, c + 1
                split_children.append((gg, c, c + 1))
                c += 2
            else:
                ktab[gg] = c
                kept.append((c, gg))
                c += 1

        salt = _mix_host(seed_base ^ _mix_host(0xA11CE + level))
        normals_d, aux_d, lc_d, none_d = _level_step(
            ctx.metric, ctx.dims, g, shards, dev0, lens, active, ltab, rtab, ktab, salt
        )
        left_cnt, none_mask, aux = lc_d.cpu().numpy(), none_d.cpu().numpy(), aux_d.cpu().numpy()

        # stage the real hyperplanes (rows of the splitting segments, in
        # ascending segment order)
        pos_of = {int(gg): i for i, gg in enumerate(np.nonzero(active)[0])}
        staged = [gg for gg, _, _ in split_children if not none_mask[gg]]
        row_of: dict[int, int] = {}
        if staged:
            pos = [pos_of[gg] for gg in staged]
            base = ctx.stage_chunk(normals_d[torch.tensor(pos, device=dev0)], aux[pos])
            for i, gg in enumerate(staged):
                row_of[gg] = base + i

        node_next: dict[int, int] = {}
        lens_next = np.zeros(c, np.int64)
        indexed_now = 0
        for new_g, old_g in kept:
            node_next[new_g] = node_of[old_g]
            lens_next[new_g] = lens[old_g]
        for old_g, lg, rg in split_children:
            l_id = ctx.alloc.next()
            r_id = ctx.alloc.next()
            ctx.forest.put_split(node_of[old_g], l_id, r_id, row_of.get(old_g))
            node_next[lg] = l_id
            node_next[rg] = r_id
            lens_next[lg] = int(left_cnt[old_g])
            lens_next[rg] = lens[old_g] - int(left_cnt[old_g])
            for child_g in (lg, rg):
                if lens_next[child_g] <= ctx.split_after:
                    indexed_now += int(lens_next[child_g])
        node_of = node_next
        lens = lens_next
        level += 1
        if indexed_now:
            ctx.on_items_indexed(indexed_now)

    # materialize the leaves: one download of the final labels
    flat = np.concatenate([sh.seg.cpu().numpy() for sh in shards], axis=1).ravel()
    slot_of_entry = np.tile(np.arange(m_pad, dtype=np.int64), s_count)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(len(lens) + 1))
    nids, arrays = [], []
    for gg, nid in node_of.items():
        slots = slot_of_entry[order[starts[gg]:starts[gg + 1]]]
        nids.append(nid)
        arrays.append(np.sort(ctx.slot_to_id[slots].astype(np.int64)).astype(np.uint32))
        if flushed and lens[gg] > ctx.split_after:
            ctx.on_items_indexed(len(slots))
            ctx.valve_items += len(slots)
    ctx.forest.put_leaves(np.asarray(nids, np.int64), arrays)
