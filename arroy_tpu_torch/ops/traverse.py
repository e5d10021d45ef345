"""Kernel 4: the best-first pop loop of a query batch.

Counterpart of the pop loop of `arroy_tpu/search.py:_traverse_impl`, a
per-query `lax.while_loop` under `vmap` that the JAX package compiles
with XLA (it has no Pallas kernel).  `traverse` dispatches on where its
tensors live: on a CUDA device it launches the hand-written kernel
(`csrc/traverse.cu`: a warp a query, the queue an 8-ary max-heap of
packed 64-bit keys in shared memory, each pop's reads issued before the
queue is sifted, the whole loop in one launch) or raises; on the CPU it
runs `traverse_reference`, the plain PyTorch version (the queue as
[B, q_cap] tensors, ~56 batched ops a pop, a host read every
`POP_BLOCK` pops), which `search._traverse_batch` names too.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT_NONE
from ..utils import profiling
from . import _build

#: kernel launches on the card (test/smoke observability)
launches = {"traverse": 0}
#: heap slots a query keeps in shared memory (8-byte keys: 112 KiB, so
#: two queries fit an SM); slots past it live in a per-query global scratch
SMEM_LANES = 14_336
#: children of a heap slot in the kernel's queue
HEAP_ARITY = 8
#: pops the plain loop runs between two host reads of the batch's "any
#: query still active" flag
POP_BLOCK = 16

_INF = float("inf")


def traverse_reference(
    margins, node_table, leaf_items, roots, search_k, search_k_dyn, pmax, w,
    q_cap=None, l_cap=None, filter_words=None, stats=None,
):
    """The best-first pop loop of a query batch (`_traverse_impl` with
    ``expand=False``: its `one` body, or `one_filtered` when
    ``filter_words`` is given).

    ``margins`` [B, S] hold every query's margin against every split plane
    (`Metric.margin_matrix`), so the loop never touches the d-wide
    normals.  Returns ``(out, pops, n_cand)``, each [B]-leading int64:
    unfiltered, ``out`` is the [B, l_cap] leaf log (the leaf index of each
    non-empty window popped, in pop order; the tail slot holds their
    count, entries past it are 0); filtered (``filter_words``: the
    candidate bitmap as int32 words), ``out`` is the [B, search_k + w]
    buffer of filter-accepted slots, -1 padded.

    ``q_cap`` must hold every push, ``t + min(pmax, n_splits)`` lanes or
    more (a split node has one parent, so it is pushed at most once), and
    ``search_k_dyn <= search_k``.  Finished queries are frozen by the
    per-query ``active`` mask, so pops past their end change nothing.
    ``stats`` (a dict, if given) gets the loop's step count as "steps"."""
    b, s_rows = margins.shape
    dev = margins.device
    t = int(roots.shape[0])
    q_cap = t + pmax if q_cap is None else q_cap
    l_cap = min(search_k, pmax) + 1 if l_cap is None else l_cap
    if search_k_dyn > search_k:
        raise ValueError(f"search_k_dyn {search_k_dyn} > search_k {search_k}")
    cap = search_k + w
    # the queue; lane q_cap takes the masked-off writes and is never read
    # (every read goes through the [:, :q_cap] views).  Per-query state is
    # kept as [B, 1] columns, so each lane is read with `gather` and
    # written with `scatter_`: O(B) work a pop, one op each.
    pq_dist = torch.full((b, q_cap + 1), -_INF, device=dev)
    pq_node = torch.zeros((b, q_cap + 1), dtype=torch.int64, device=dev)
    pq_dist[:, :t] = _INF
    pq_node[:, :t] = roots
    dist_v, node_v = pq_dist[:, :q_cap], pq_node[:, :q_cap]
    n_pushed = torch.full((b, 1), t, dtype=torch.int64, device=dev)
    n_cand = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    pops = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    filtered = filter_words is not None
    if filtered:
        w_iota = torch.arange(w, device=dev)
        targets = (w_iota + 1).expand(b, w).contiguous()
        cand = torch.full((b, cap + 1), -1, dtype=torch.int64, device=dev)  # column cap: trash
    else:
        leaf_log = torch.zeros((b, l_cap), dtype=torch.int64, device=dev)
        n_leaf = torch.zeros((b, 1), dtype=torch.int64, device=dev)

    def running():
        return (n_cand < search_k_dyn) & (pops < pmax)

    # every active pop adds 1 to `pops` or sets it to pmax: pmax steps end
    # every query
    done = 0
    while done < pmax:
        steps = min(POP_BLOCK, pmax - done)
        for _ in range(steps):
            active = running()
            # max-queue pop: max dist, ties to the larger node id, then the
            # first lane (BinaryHeap<(OrderedFloat, NodeId)>, reference
            # src/reader.rs:342); argmax returns the first maximal index
            m = dist_v.amax(dim=1, keepdim=True)
            at_m = dist_v == m
            nid = torch.where(at_m, node_v, -1).amax(dim=1, keepdim=True)
            i = (at_m & (node_v == nid)).to(torch.uint8).argmax(dim=1, keepdim=True)
            # kind, left, right, ptr, leaf_off, leaf_cnt
            row = node_table.index_select(0, nid.view(-1)).long()
            knd, p = row[:, 0:1], row[:, 3:4]
            alive = m > -_INF
            go = active & alive
            is_leaf = go & (knd == KIND_LEAF)
            # FREE rows (deleted nodes, sharding padding) pop as no-ops so a
            # dangling id drains the queue instead of spinning on it
            is_split = go & (knd != KIND_LEAF) & (knd != KIND_FREE)
            cnt = torch.where(is_leaf, row[:, 5:6], 0)
            if filtered:
                # the leaf's window compacted to its accepted items (the
                # accepted items of a leaf are not contiguous in the CSR,
                # and only they count toward search_k, reference
                # src/reader.rs:354-360).  leaf_items ends in w entries of
                # padding, so off + w never runs past it (where the JAX
                # package's dynamic_slice would clamp the start).
                win = leaf_items.take(row[:, 4:5] + w_iota).long()
                slot_c = win.clamp(min=0)
                bit = (filter_words.take(slot_c >> 5) >> (slot_c & 31)) & 1
                valid = (w_iota < cnt) & (bit == 1)  # none unless is_leaf
                csum = valid.cumsum(dim=1)
                n_valid = csum[:, -1:]
                src = torch.searchsorted(csum, targets).clamp(max=w - 1)
                pos = torch.where(w_iota < n_valid, n_cand + w_iota, cap)
                cand.scatter_(1, pos, torch.gather(win, 1, src))
                n_cand += n_valid
            else:
                # log the window's CSR row (cnt > 0 only for a leaf pop);
                # the windows are expanded after the loop (`_expand_log`)
                log_it = (cnt > 0) & (n_leaf < l_cap - 1)
                leaf_log.scatter_(1, torch.where(log_it, n_leaf, l_cap - 1), p)
                n_leaf += log_it
                n_cand += cnt
            # split: the precomputed margin; the left child takes the popped
            # lane, the right one is pushed at n_pushed
            margin = torch.gather(margins, 1, p.clamp(0, s_rows - 1))
            margin = torch.where(knd == KIND_SPLIT_NONE, 0.0, margin)
            pq_dist.scatter_(
                1, torch.where(go, i, q_cap), torch.where(is_split, torch.minimum(m, -margin), -_INF)
            )
            pq_node.scatter_(1, torch.where(is_split, i, q_cap), row[:, 1:2])
            at = torch.where(is_split, n_pushed, q_cap)
            pq_dist.scatter_(1, at, torch.minimum(m, margin))
            pq_node.scatter_(1, at, row[:, 2:3])
            n_pushed += is_split
            pops += go
            pops.masked_fill_(active & ~alive, pmax)  # an empty queue ends the query
        done += steps
        if not bool(running().any()):  # the one host sync of a block
            break
    if stats is not None:
        stats["steps"] = done
    pops, n_cand = pops.view(-1), n_cand.view(-1)
    if filtered:
        return cand[:, :cap], pops, n_cand
    leaf_log[:, l_cap - 1] = n_leaf.view(-1)
    return leaf_log, pops, n_cand


def _lib():
    lib = _build.load("traverse")
    lib.traverse.restype = ctypes.c_int
    lib.traverse.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
    )
    lib.chase.restype = ctypes.c_int
    lib.chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def heap_slots(q_cap: int) -> tuple[int, int]:
    """A query's heap array in the kernel: (slots in shared memory, slots
    in the global scratch).  Slot s of the 8-ary heap sits at array index
    s + 7, so each slot's 8 children fill one aligned group; the array is
    whole groups, at most `SMEM_LANES` of them in shared memory."""
    total = -(-(q_cap + HEAP_ARITY - 1) // HEAP_ARITY) * HEAP_ARITY
    sm = min(total, SMEM_LANES // HEAP_ARITY * HEAP_ARITY)
    return sm, total - sm


def l2_chase(next_idx: torch.Tensor, steps: int, sink: torch.Tensor) -> None:
    """Follow ``steps`` links of the int32 permutation cycle ``next_idx``
    on the card with one thread, through L2 (a measuring aid: the time a
    step takes is one dependent L2 read, the floor of a pop)."""
    with torch.cuda.device(next_idx.device):
        rc = _lib().chase(next_idx.data_ptr(), steps, sink.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "chase")


def work(pops: torch.Tensor, filtered: bool) -> dict:
    """The work record of one call (`utils.profiling.counting`): B,
    whether it was filtered, and the pops it reported, the longest
    query's and in all (a query whose queue ran empty reports ``pmax``)."""
    n = pops.numel()
    return {"kernel": "traverse", "B": n, "filtered": filtered,
            "pops_max": int(pops.max()) if n else 0, "pops_total": int(pops.sum())}


def traverse(
    margins, node_table, leaf_items, roots, search_k, search_k_dyn, pmax, w,
    q_cap=None, l_cap=None, filter_words=None, stats=None,
):
    """The pop loop of a query batch: `traverse_reference`'s arguments and
    output ``(out, pops, n_cand)``, bit for bit.

    margins:      [B, S] f32, every query's margin against every split plane
    node_table:   [N, >= 6] int32 rows (kind, left, right, ptr, leaf_off, leaf_cnt)
    leaf_items:   int32 CSR slots ending in ``w`` entries of padding
    roots:        [t] int node ids
    filter_words: the candidate bitmap as int32 words, or None (unfiltered)

    On the card the first `SMEM_LANES` heap slots of a query live in
    shared memory and the rest in a global scratch (`heap_slots`).  ``stats`` is filled
    by the plain loop only (its step count): the kernel's steps are its
    pops, and nothing is read back from the card."""
    if margins.device.type == "cpu":
        out = traverse_reference(margins, node_table, leaf_items, roots, search_k, search_k_dyn,
                                 pmax, w, q_cap, l_cap, filter_words, stats)
    else:
        out = _launch(margins, node_table, leaf_items, roots, search_k, search_k_dyn, pmax, w,
                      q_cap, l_cap, filter_words)
    sink = profiling.work_sink()
    if sink is not None:
        sink.append(work(out[1], filter_words is not None))
    return out


def _launch(margins, node_table, leaf_items, roots, search_k, search_k_dyn, pmax, w,
            q_cap, l_cap, filter_words):
    """`traverse` on the card: kernel 4, one launch."""
    if margins.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {margins.device}")
    b, s_rows = margins.shape
    t = int(roots.shape[0])
    q_cap = t + pmax if q_cap is None else q_cap
    l_cap = min(search_k, pmax) + 1 if l_cap is None else l_cap
    if search_k_dyn > search_k:
        raise ValueError(f"search_k_dyn {search_k_dyn} > search_k {search_k}")
    if margins.dtype != torch.float32:
        raise TypeError(f"traverse: margins must be float32, got {margins.dtype}")
    if node_table.dtype != torch.int32 or leaf_items.dtype != torch.int32:
        raise TypeError(f"traverse: node_table and leaf_items must be int32, got "
                        f"{node_table.dtype}/{leaf_items.dtype}")
    if filter_words is not None and filter_words.dtype != torch.int32:
        raise TypeError(f"traverse: filter_words must be int32, got {filter_words.dtype}")
    if node_table.dim() != 2 or node_table.shape[1] < 6 or margins.dim() != 2 or roots.dim() != 1:
        raise ValueError("traverse: expected margins [B, S], node_table [N, >= 6], roots [t]")
    if t > q_cap or l_cap < 1:
        raise ValueError(f"traverse: q_cap {q_cap} below the {t} roots, or l_cap {l_cap} < 1")
    roots = roots.to(torch.int64)
    tensors = [margins, node_table, leaf_items, roots]
    if filter_words is not None:
        tensors.append(filter_words)
    if any(x.device != margins.device or not x.is_contiguous() for x in tensors):
        raise ValueError("traverse: tensors must be contiguous on one device")
    if node_table.shape[1] != 8 or node_table.data_ptr() % 16:
        # the kernel reads a row as two 16-byte loads: 8 columns, aligned
        padded = torch.zeros((node_table.shape[0], 8), dtype=torch.int32, device=margins.device)
        padded[:, :6] = node_table[:, :6]
        node_table = padded
    filtered = filter_words is not None
    out_w = search_k + w if filtered else l_cap
    out = torch.empty((b, out_w), dtype=torch.int64, device=margins.device)
    pops = torch.empty(b, dtype=torch.int64, device=margins.device)
    n_cand = torch.empty(b, dtype=torch.int64, device=margins.device)
    ns, n_scratch = heap_slots(q_cap)
    scratch = None
    if n_scratch and b:
        scratch = torch.empty(b * n_scratch, dtype=torch.int64, device=margins.device)
    if b:
        with torch.cuda.device(margins.device):
            rc = _lib().traverse(
                margins.data_ptr(), b, s_rows, node_table.data_ptr(), node_table.shape[0],
                node_table.shape[1], leaf_items.data_ptr(), roots.data_ptr(), t,
                None if filter_words is None else filter_words.data_ptr(),
                0 if filter_words is None else filter_words.numel(), search_k_dyn, pmax, w,
                q_cap, out_w, ns, n_scratch, out.data_ptr(), pops.data_ptr(), n_cand.data_ptr(),
                None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        _build.check(rc, "traverse")
        launches["traverse"] += 1
    return out, pops, n_cand
