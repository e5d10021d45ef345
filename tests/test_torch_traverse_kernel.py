"""Kernel 4's contract, held on the CPU, where the kernel cannot run.

Kernel 4 (`arroy_tpu_torch/csrc/traverse.cu`) must return exactly what
the plain pop loop (`search._traverse_batch`, `ops.traverse.
traverse_reference`) returns.  Three things are held here:

1. the plain loop is bit-equal to the JAX package's `_traverse_impl`,
   given the JAX package's margins, on the corner cases the kernel has to
   meet: KIND_SPLIT_NONE splits (a corpus with a block of identical
   vectors), FREE roots padded in as the sharded forest pads them, a leaf
   log that overflows ``l_cap``, a queue that empties, and the filtered
   window of the last leaf in the CSR.  The indexes are built by the JAX
   package and handed to the port through ``DeviceIndex.from_numpy``;
2. for every query of a batch in which only some queries outgrow the
   small tier, the plain loop at the full budget gives what the two-tier
   walk gives, and the kernel path's device-side outcome
   ``(pops > pmax_small) | (n_cand < sk)`` marks exactly the queries the
   small tier cuts.  This is what lets `TraversalFn.walk` launch kernel 4
   once at the full budget on the card;
3. a Python model of the kernel's queue (the same binary heap, slot
   split between shared and global memory, and key compare as
   ``traverse.cu``) gives the plain loop's ``(out, pops, n_cand)`` on
   hundreds of random forests whose margins tie, ±0.0 included.

Tolerance: bit-equal everywhere (integer state; distances are only
compared, never returned).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arroy_tpu
from arroy_tpu import search as j_search
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.device import DeviceIndex as TDeviceIndex
from arroy_tpu_torch.metrics import metric_by_name
from arroy_tpu_torch.models.forest import KIND_FREE, KIND_LEAF, KIND_SPLIT_NONE
from arroy_tpu_torch.ops import traverse as tv

from .torch_util import query_arrays

DIM, B = 32, 24
INF = float("inf")


def _corpus(seed=3, n=900, dups=220):
    """Clustered items with a block of identical vectors (whose splits
    fall back to KIND_SPLIT_NONE) and queries near both."""
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((12, DIM)).astype(np.float32)
    x = parents[rng.integers(12, size=n)] + 0.1 * rng.standard_normal((n, DIM)).astype(np.float32)
    x[:dups] = x[0]
    near, far = B // 3, B - B // 3
    q = np.concatenate([x[:near] + 0.01 * rng.standard_normal((near, DIM)).astype(np.float32),
                        x[n - far:] + 0.3 * rng.standard_normal((far, DIM)).astype(np.float32)])
    return x, q


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(JAX DeviceIndex, the port's DeviceIndex from the JAX pack, pack,
    queries) over one JAX-built euclidean index."""
    x, q = _corpus()
    path = str(tmp_path_factory.mktemp("kernel4"))
    db = arroy_tpu.Database(path)
    w = arroy_tpu.Writer(db, 0, DIM, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=5).n_trees(4).split_after(12).build(wtxn)
    jr = arroy_tpu.Reader.open(db.read(), 0, db, metric="euclidean")
    jdev = jr._device()
    pack = JDeviceIndex.build_np(jdev.metric, DIM, jr._state.store, jr._state.forest)
    assert (pack["node_table"][:, 0] == KIND_SPLIT_NONE).sum() > 0
    tdev = TDeviceIndex.from_numpy(pack, metric_by_name("euclidean"), DIM, "cpu")
    return jdev, tdev, pack, q


def _jax_margins(jdev, qv, qf):
    m = jax.jit(jdev.metric.margin_matrix)(jdev.normals, jdev.aux, jnp.asarray(qv), jnp.asarray(qf))
    return np.array(m)


def _sharded_pad(pack, extra):
    """The sharded forest's padding (`arroy_tpu/parallel/forest.py:76-91`):
    one trailing FREE row, ``extra`` more roots that point at it."""
    nt = pack["node_table"]
    pad = np.zeros((1, nt.shape[1]), np.int32)
    pad[:, 0] = KIND_FREE
    node_table = np.concatenate([nt, pad])
    roots = np.concatenate([np.asarray(pack["roots"], np.int64),
                            np.full(extra, nt.shape[0], np.int64)])
    return node_table, roots


def _filter_words(slots, n_slots):
    words = np.zeros(max((n_slots + 31) // 32, 1), np.uint32)
    np.bitwise_or.at(words, slots >> 5, np.uint32(1) << (slots & 31).astype(np.uint32))
    return words


def _case(name, pack, n_items):
    """(search_k, search_k_dyn, pmax, q_cap, l_cap, node_table, roots,
    filter slots) of one corner case."""
    nt, roots = pack["node_table"], np.asarray(pack["roots"], np.int64)
    t, n_nodes = len(roots), int(pack["n_nodes"])
    csr_total = int(pack["leaf_items"].shape[0]) - int(pack["max_leaf"])
    filt = None
    if name == "split_none":
        sk_dyn, pmax = 200, 2 * t + 400 + 64
    elif name == "free_roots":
        nt, roots = _sharded_pad(pack, 3)
        t = len(roots)
        sk_dyn, pmax = 200, 2 * t + 400 + 64
    elif name == "l_cap_overflow":
        sk_dyn, pmax = 300, 2 * t + 600 + 64
    elif name == "empty_queue":
        # more candidates than the forest holds: every node pops, the queue
        # empties, and pops is set to pmax
        sk_dyn, pmax = csr_total + 1, n_nodes + t + 5
    else:  # "filtered_tail": the last leaf's window is the CSR's last
        li_last = int(np.argmax(pack["leaf_off"]))
        off, cnt = int(pack["leaf_off"][li_last]), int(pack["leaf_cnt"][li_last])
        last = pack["leaf_items"][off:off + cnt]
        assert off + cnt == csr_total and cnt > 0
        rng = np.random.default_rng(4)
        filt = np.union1d(last, rng.choice(n_items, 150, replace=False)).astype(np.int64)
        # past every accepted entry of every tree: every window is compacted
        sk_dyn, pmax = int(np.isin(pack["leaf_items"][:csr_total], filt).sum()) + 1, n_nodes + t + 5
    sk = t_search._next_pow2(sk_dyn)
    q_cap = t + pmax
    l_cap = 4 if name == "l_cap_overflow" else min(sk, pmax) + 1
    return sk, sk_dyn, pmax, q_cap, l_cap, nt, roots, filt


CASES = ["split_none", "free_roots", "l_cap_overflow", "empty_queue", "filtered_tail"]


@pytest.mark.parametrize("name", CASES)
def test_plain_loop_matches_jax_on_corner_cases(built, name):
    jdev, tdev, pack, q = built
    qv, qn, qe, qf = query_arrays(tdev.metric, q)
    sk, sk_dyn, pmax, q_cap, l_cap, nt, roots, filt = _case(name, pack, tdev.n_items)
    w = int(pack["max_leaf"])
    words = None if filt is None else _filter_words(filt, tdev.cap)
    jm = _jax_margins(jdev, qv, qf)
    want = j_search._traverse_batch(
        jdev.metric, sk, pmax, w, words is not None, jnp.asarray(nt), jdev.normals, jdev.aux,
        jdev.leaf_off, jdev.leaf_cnt, jdev.leaf_items, jnp.asarray(roots.astype(np.int32)),
        jnp.asarray(qv), jnp.asarray(qf),
        jnp.zeros(1, jnp.uint32) if words is None else jnp.asarray(words),
        jnp.int32(sk_dyn), q_cap=q_cap, l_cap=l_cap, expand=words is not None,
    )
    want = [np.asarray(a) for a in want]
    fw = None if words is None else torch.from_numpy(words.view(np.int32))
    got = t_search._traverse_batch(
        torch.from_numpy(jm), torch.from_numpy(nt), tdev.leaf_items, torch.from_numpy(roots), sk,
        sk_dyn, pmax, w, q_cap=q_cap, l_cap=l_cap, filter_words=fw,
    )
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), j)
    out, pops, n_cand = (g.numpy() for g in got)
    # the model of the kernel's queue agrees on the same inputs
    model = _model(jm, nt, tdev.leaf_items.numpy(), roots, words, sk, sk_dyn, pmax, w, q_cap, l_cap,
                   ns=max(q_cap // 3, 1))
    for g, mdl in zip((out, pops, n_cand), model):
        np.testing.assert_array_equal(g, mdl)
    if name == "l_cap_overflow":
        assert (out[:, -1] == l_cap - 1).all() and (n_cand >= sk_dyn).all()
    elif name == "empty_queue":
        assert (pops == pmax).all() and (n_cand < sk_dyn).all()
    elif name == "filtered_tail":
        assert (pops == pmax).all() and (n_cand == sk_dyn - 1).all()
        assert all(set(row[row >= 0].tolist()) == set(filt.tolist()) for row in out)
    elif name == "free_roots":
        # the FREE roots pop first (+inf, the largest id) as no-ops: 3 more
        # pops than the same walk without them
        base = t_search._traverse_batch(
            torch.from_numpy(jm), torch.from_numpy(pack["node_table"]), tdev.leaf_items,
            torch.from_numpy(np.asarray(pack["roots"], np.int64)), sk, sk_dyn, pmax, w,
            q_cap=q_cap, l_cap=l_cap,
        )
        np.testing.assert_array_equal(out, base[0].numpy())
        np.testing.assert_array_equal(pops, base[1].numpy() + 3)
    else:
        # some query reached a KIND_SPLIT_NONE node
        assert _pops_kind(jm, nt, roots, pmax, KIND_SPLIT_NONE, tdev.leaf_items.numpy(), sk, sk_dyn,
                          w, q_cap, l_cap) > 0


def _pops_kind(margins, nt, roots, pmax, kind, leaf_items, sk, sk_dyn, w, q_cap, l_cap):
    seen = []
    _model(margins, nt, leaf_items, roots, None, sk, sk_dyn, pmax, w, q_cap, l_cap, ns=q_cap,
           on_pop=lambda k: seen.append(k))
    return sum(k == kind for k in seen)


# ---------------------------------------------------------------------------
# 2. the full budget per query against the two-tier walk
# ---------------------------------------------------------------------------


def test_full_budget_equals_two_tier_per_query(built):
    _, tdev, _, q = built
    qv, qn, qe, qf = query_arrays(tdev.metric, q)
    fn, route = t_search.make_search_fn(tdev, 10, 300, traversal="xla")
    assert route == "traversal"
    qv_t, qf_t = torch.from_numpy(qv), torch.from_numpy(qf)
    m = fn.margins(qv_t, qf_t)
    full = fn.traverse(m, fn.pmax, fn.q_cap)
    pops_f = full[1].numpy()
    # a small budget that cuts some queries and not others
    fn.pmax_small = int(np.median(pops_f))
    fn.q_cap_small = len(tdev.roots) + min(fn.pmax_small, tdev.n_splits) + 1
    fn.two_tier = True
    small = fn.traverse(m, fn.pmax_small, fn.q_cap_small)
    cut = ((small[1] >= fn.pmax_small) & (small[2] < fn.sk_exact)).numpy()
    assert 0 < cut.sum() < len(q)
    for s_, f_ in zip(small, full):
        np.testing.assert_array_equal(s_.numpy()[~cut], f_.numpy()[~cut])
    # the kernel path's outcome, from the full budget's pops and counts alone
    np.testing.assert_array_equal(((full[1] > fn.pmax_small) | (full[2] < fn.sk_exact)).numpy(), cut)
    # the two-tier walk (the CPU's, host-decided) gives the full budget's
    # output for every query
    out = fn.walk(m)
    np.testing.assert_array_equal(out.numpy(), full[0].numpy())
    np.testing.assert_array_equal(fn.last_pops.numpy(), pops_f)
    assert fn.fallbacks == 1 and fn.last_small_ok is False


# ---------------------------------------------------------------------------
# 3. the kernel's queue, modelled, against the plain loop on random forests
# ---------------------------------------------------------------------------


_ARITY = tv.HEAP_ARITY
_ROOT = _ARITY - 1  # the root's array index: each slot's children fill one aligned group
_DEAD_HI = 0x007FFFFF  # `pack`'s high word at -inf
_WINDOW_CHUNKS = 24  # traverse.cu kWindowChunks: 32-item chunks a lane loads in one round
_GARBAGE = (1 << 64) - 1  # what an uncleared slot holds in the model: above every key
_FREE_ROW = (KIND_FREE, 0, 0, 0, 0, 0)


def _pack(d, n):
    """traverse.cu `pack`: (distance, node id) as one key whose unsigned
    order is the pop order; -0.0 is taken as +0.0, so ±0.0 tie."""
    b = int(np.float32(0.0 if d == 0 else d).view(np.uint32))
    b = (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000
    return (b << 32) | ((int(n) & 0xFFFFFFFF) ^ 0x80000000)


def _key_dist(k):
    b = k >> 32
    return np.uint32(b & 0x7FFFFFFF if b & 0x80000000 else ~b & 0xFFFFFFFF).view(np.float32)


def _key_node(k):
    n = (k & 0xFFFFFFFF) ^ 0x80000000
    return n - (1 << 32) if n & 0x80000000 else n


class _Heap:
    """traverse.cu `Heap`: an 8-ary max-heap of keys, slot s at array
    index s + 7; indices [0, ns) 'shared', the rest 'global' (ns from
    `SMEM_LANES` as `ops.traverse.heap_slots` takes it).  Slots start as
    garbage above every key, so a read past the heap's end that the kernel
    relies on being 0 shows as a wrong pop."""

    def __init__(self, q_cap, smem_lanes):
        total = -(-(q_cap + _ROOT) // _ARITY) * _ARITY
        self.ns = min(total, smem_lanes // _ARITY * _ARITY)
        self.sm, self.gl = [_GARBAGE] * self.ns, [_GARBAGE] * (total - self.ns)

    def _read(self, i):
        return self.sm[i] if i < self.ns else self.gl[i - self.ns]

    def _write(self, i, k):
        if i < self.ns:
            self.sm[i] = k
        else:
            self.gl[i - self.ns] = k

    def get(self, s):
        return self._read(s + _ROOT)

    def put(self, s, k):
        self._write(s + _ROOT, k)

    def max_child(self, s):
        """The largest key among slot s's children and its slot, by the
        kernel's pairwise tree (a tie keeps the lower slot)."""
        base = _ARITY * (s + 1)
        assert (base < self.ns) == (base + _ARITY - 1 < self.ns)  # one group, one memory
        k = [self._read(base + j) for j in range(_ARITY)]
        j = list(range(_ARITY))
        w = 1
        while w < _ARITY:
            for i in range(0, _ARITY, 2 * w):
                if k[i + w] > k[i]:
                    k[i], j[i] = k[i + w], j[i + w]
            w *= 2
        return k[0], _ARITY * s + 1 + j[0]

    def sift_down(self, size, e):
        s = 0
        while _ARITY * s + 1 < size:
            m, c = self.max_child(s)
            if m <= e:
                break
            self.put(s, m)
            s = c
        self.put(s, e)

    def push(self, s, e):
        if s > 0 and (s - 1) % _ARITY == 0:
            for j in range(_ARITY):
                self._write(s + _ROOT + j, 0)
        while s > 0:
            q = (s - 1) // _ARITY
            pe = self.get(q)
            if e <= pe:
                break
            self.put(s, pe)
            s = q
        self.put(s, e)


def _is_split(kind):
    return kind != KIND_LEAF and kind != KIND_FREE


def _model(margins, nt, leaf_items, roots, words, sk, sk_dyn, pmax, w, q_cap, l_cap, ns,
           on_pop=None, trace=None):
    """traverse.cu's loop, one query at a time, in Python, in the kernel's
    order of work: the top entry held apart from the heap, and a pop
    that takes the `top` predicted at the pop before and the row (and, for
    a filtered leaf, the window's slots) read for it then, before the heap
    was updated, so a wrong prediction shows as a wrong output.  ``trace`` (a list, if given) gets, for every pop that
    leaves the queue non-empty, (the predicted top, the largest key left
    in the heap, the candidates it was chosen from: the split's larger
    child, or None, and the heap's root before the update)."""
    margins = np.asarray(margins, np.float32)
    b, s_rows = margins.shape
    filtered = words is not None
    out_w = sk + w if filtered else l_cap
    out = np.full((b, out_w), -1 if filtered else 0, np.int64)
    pops_o, ncand_o = np.zeros(b, np.int64), np.zeros(b, np.int64)

    def load_row(n):
        return tuple(int(v) for v in nt[n, :6]) if 0 <= n < len(nt) else _FREE_ROW

    for qi in range(b):
        mrow = margins[qi]

        def fetch(r):
            """(margin, left child's row, right child's row) of a split."""
            if not _is_split(r[0]):
                return np.float32(0.0), None, None
            mg = np.float32(0.0)
            if r[0] != KIND_SPLIT_NONE and s_rows > 0:
                mg = mrow[min(max(r[3], 0), s_rows - 1)]
            return mg, load_row(r[1]), load_row(r[2])

        h, hs = _Heap(q_cap, ns), 0
        for r in roots:
            h.push(hs, _pack(np.float32(INF), int(r)))
            hs += 1
        top = hmax = 0
        td, cur, mg, rl, rr = np.float32(0.0), _FREE_ROW, np.float32(0.0), None, None
        if hs > 0:
            top = h.get(0)
            td = _key_dist(top)
            cur = load_row(_key_node(top))
            mg, rl, rr = fetch(cur)
            hs -= 1
            e = h.get(hs)
            h.put(hs, 0)
            if hs > 0:
                h.sift_down(hs, e)
            hmax = h.get(0) if hs > 0 else 0
        def window_slots(r):
            """A filtered leaf's window, read when the leaf is known to
            pop next (the kernel loads it at the pop before)."""
            if not filtered or r[0] != KIND_LEAF:
                return []
            return [int(leaf_items[r[4] + j]) for j in range(min(r[5], w))]

        pops = n_leaf = n_cand = 0
        n_pushed = len(roots)
        slots = window_slots(cur)
        while n_cand < sk_dyn and pops < pmax:
            if not (top >> 32) > _DEAD_HI:
                pops = pmax
                break
            kind, left, right, ptr, off, cnt = cur
            if on_pop is not None:
                on_pop(kind)
            nxt, kp, pushed, take_root, nrow = hmax, 0, 0, True, cur
            if not _is_split(kind):
                if kind == KIND_LEAF and filtered:
                    # the window's slots (read at the pop before), then
                    # their filter words, then the accepted items in window
                    # order, in rounds of _WINDOW_CHUNKS chunks of 32
                    assert len(slots) == min(cnt, w)
                    for base in range(0, len(slots), 32 * _WINDOW_CHUNKS):
                        chunk = slots[base:base + 32 * _WINDOW_CHUNKS]
                        wds = [int(words[max(s_, 0) >> 5]) if max(s_, 0) >> 5 < len(words) else 0
                               for s_ in chunk]
                        for s_, wd in zip(chunk, wds):
                            if (wd >> (max(s_, 0) & 31)) & 1:
                                out[qi, n_cand] = s_
                                n_cand += 1
                elif kind == KIND_LEAF:
                    if cnt > 0 and n_leaf < l_cap - 1:
                        out[qi, n_leaf] = ptr
                        n_leaf += 1
                    n_cand += cnt
                split_cand = None
            else:
                kl, kr = _pack(min(td, -mg), left), _pack(min(td, mg), right)
                kp, rp = kl, rl
                if n_pushed < q_cap:
                    pushed = kr
                    if kr > kl:
                        kp, pushed, rp = kr, kl, rr
                n_pushed += 1
                split_cand = kp
                if kp > hmax:
                    take_root, nxt, nrow = False, kp, rp
            # the next pop's reads, before the heap is touched
            if take_root:
                nrow = load_row(_key_node(nxt))
            cur = nrow
            mg, rl, rr = fetch(cur)
            slots = window_slots(cur)
            old_hmax, top, td = hmax, nxt, _key_dist(nxt)
            if take_root and hs > 0:
                if not kp:  # no key replaces the root: the last one fills it
                    hs -= 1
                    kp = h.get(hs)
                    h.put(hs, 0)
                if hs > 0:
                    h.sift_down(hs, kp)
            if pushed:
                h.push(hs, pushed)
                hs += 1
            hmax = h.get(0) if hs > 0 else 0
            if trace is not None and top:
                trace.append((top, max((h.get(s_) for s_ in range(hs)), default=0),
                              (split_cand, old_hmax)))
            pops += 1
        if not filtered:
            out[qi, l_cap - 1] = n_leaf
        pops_o[qi], ncand_o[qi] = pops, n_cand
    return out, pops_o, ncand_o


#: margins drawn from few values, ±0.0 among them, so distances tie often
_TIE_VALUES = np.array([-1.0, -0.5, -0.0, 0.0, 0.0, 0.5, 1.0, 2.0], np.float32)


def _random_forest(rng, wide=0, max_depth_hi=6):
    """(node_table [N, 8] int32, leaf_items, roots int64, n_slots, w,
    n_splits): a few random trees with FREE children, empty leaves, KIND_SPLIT_NONE
    splits, split planes shared between nodes, and repeated or FREE roots.
    With ``wide``, the first leaf holds ``wide`` items (so w = wide) and
    one leaf in ten up to ``wide``."""
    rows, csr = [], []
    n_slots = int(rng.integers(8, 64))
    max_depth = int(rng.integers(1, max_depth_hi))
    n_leaves = [0]

    def node(depth):
        nid = len(rows)
        rows.append(None)
        r = rng.random()
        if depth >= max_depth or r < 0.25:
            cnt = int(rng.integers(0, 6))
            if wide:
                cnt = wide if n_leaves[0] == 0 else (int(rng.integers(0, wide + 1))
                                                     if rng.random() < 0.1 else cnt)
            off = len(csr)
            csr.extend(rng.integers(0, n_slots, cnt).tolist())
            rows[nid] = (KIND_LEAF, 0, 0, n_leaves[0], off, cnt)
            n_leaves[0] += 1
        elif r < 0.3:
            rows[nid] = (KIND_FREE, 0, 0, 0, 0, 0)
        else:
            kind = KIND_SPLIT_NONE if rng.random() < 0.2 else 0
            ptr = int(rng.integers(0, 6))
            left = node(depth + 1)
            right = node(depth + 1)
            rows[nid] = (kind, left, right, ptr, 0, 0)
        return nid

    roots = [node(0) for _ in range(int(rng.integers(1, 5)))]
    if rng.random() < 0.3:
        roots.append(roots[0])  # a repeated root: every node of its tree queued twice
    if rng.random() < 0.3:
        free = len(rows)
        rows.append((KIND_FREE, 0, 0, 0, 0, 0))
        roots += [free] * int(rng.integers(1, 4))
    w = max(max((r[5] for r in rows), default=0), 1)
    nt = np.zeros((len(rows), 8), np.int32)
    nt[:, :6] = np.asarray(rows, np.int32)
    leaf_items = np.asarray(csr + [-1] * w, np.int32)
    n_splits = int(((nt[:, 0] != KIND_LEAF) & (nt[:, 0] != KIND_FREE)).sum())
    return nt, leaf_items, np.asarray(roots, np.int64), n_slots, w, n_splits


def _random_case(rng, wide=0, max_depth_hi=6):
    """A random forest and one batch's inputs: margins that tie (±0.0
    among them), random budgets (pmax 0 up to past every node,
    search_k_dyn 0 up to search_k, l_cap from 1), a filter half the time
    (always with ``wide``) and a shared-memory split (0 up to every slot)."""
    nt, leaf_items, roots, n_slots, w, n_splits = _random_forest(rng, wide, max_depth_hi)
    t = len(roots)
    b = int(rng.integers(1, 4))
    margins = np.where(rng.random((b, 6)) < 0.6, rng.choice(_TIE_VALUES, (b, 6)),
                       rng.standard_normal((b, 6))).astype(np.float32)
    sk = int(rng.integers(1, 40))
    sk_dyn = int(rng.integers(0, sk + 1))
    pmax = int(rng.integers(0, len(nt) + t + 3))
    # a split is pushed once a copy of its tree (a repeated root makes two)
    q_cap = t + 2 * n_splits + 1 + int(rng.integers(0, 3))
    l_cap = int(rng.integers(1, min(sk, pmax) + 2))
    words = None
    if wide or rng.random() < 0.5:
        words = _filter_words(np.flatnonzero(rng.random(n_slots) < 0.5), n_slots)
    ns = int(rng.integers(0, q_cap + 1))
    if wide:
        sk = sk_dyn = int(rng.integers(1, 4 * wide))
    return (margins, nt, leaf_items, roots, words, sk, sk_dyn, pmax, w, q_cap, l_cap), ns


def _plain(margins, nt, leaf_items, roots, words, sk, sk_dyn, pmax, w, q_cap, l_cap):
    return t_search._traverse_batch(
        torch.from_numpy(margins), torch.from_numpy(nt), torch.from_numpy(leaf_items),
        torch.from_numpy(roots), sk, sk_dyn, pmax, w, q_cap=q_cap, l_cap=l_cap,
        filter_words=None if words is None else torch.from_numpy(words.view(np.int32)),
    )


@pytest.mark.parametrize("block", range(6))
def test_heap_model_matches_plain_loop(block):
    """50 random forests a block (`_random_case`), half filtered."""
    rng = np.random.default_rng(1000 + block)
    for _ in range(50):
        args, ns = _random_case(rng)
        for g, mdl in zip(_plain(*args), _model(*args, ns)):
            np.testing.assert_array_equal(g.numpy(), mdl)


@pytest.mark.parametrize("block", range(6))
def test_prefetch_candidates_hold_the_next_top(block):
    """On every pop of the same 300 forests, the top the kernel predicts
    before it updates the heap (whose margin and children's rows it reads
    while the heap is sifted) is at least every key left in the heap, and
    it is one of the two candidates: the popped split's larger child (its
    row read one pop earlier) or the heap's root."""
    rng = np.random.default_rng(1000 + block)
    n_pops = 0
    for _ in range(50):
        args, ns = _random_case(rng)
        trace = []
        _model(*args, ns, trace=trace)
        for predicted, heap_max, cands in trace:
            assert predicted >= heap_max and predicted in cands
        n_pops += len(trace)
    assert n_pops > 500


@pytest.mark.parametrize("block", range(2))
def test_heap_model_full_windows(block):
    """Filtered windows at w = 800 (past one round of 24 chunks of 32
    items) and deeper trees: the model against the plain loop on 25
    forests a block."""
    rng = np.random.default_rng(2000 + block)
    full = n = 0
    while n < 25:
        args, ns = _random_case(rng, wide=800, max_depth_hi=8)
        if args[8] != 800:  # a forest of FREE roots has no leaf
            continue
        n += 1
        pops = []
        got = _model(*args, ns, on_pop=pops.append)
        for g, mdl in zip(_plain(*args), got):
            np.testing.assert_array_equal(g.numpy(), mdl)
        full += KIND_LEAF in pops
    assert full > 10


def test_signed_zero_ties_by_node_id():
    """Children of a KIND_SPLIT_NONE split sit at -0.0 and +0.0 (or a split
    whose margin is 0.0): they tie, and the larger node id pops first in
    the plain loop and in the model.  A packed (dist bits, node) key would
    order -0.0 below +0.0 and pop the smaller id first."""
    # root 0 (KIND_SPLIT_NONE) pushes leaf 2 at min(+inf, -0.0) = -0.0 and
    # leaf 1 at +0.0
    nt = np.zeros((3, 8), np.int32)
    nt[0, :6] = (KIND_SPLIT_NONE, 2, 1, 0, 0, 0)
    nt[1, :6] = (KIND_LEAF, 0, 0, 0, 0, 1)
    nt[2, :6] = (KIND_LEAF, 0, 0, 1, 1, 1)
    leaf_items = np.asarray([5, 6, -1], np.int32)
    roots = np.asarray([0], np.int64)
    margins = np.zeros((1, 1), np.float32)
    got = t_search._traverse_batch(torch.from_numpy(margins), torch.from_numpy(nt),
                                   torch.from_numpy(leaf_items), torch.from_numpy(roots), 1, 1, 5, 1,
                                   q_cap=3, l_cap=3)
    # one pop of the split, then leaf 2 (id 2 > 1) fills search_k
    np.testing.assert_array_equal(got[0].numpy(), [[1, 0, 1]])
    assert int(got[1][0]) == 2
    want = _model(margins, nt, leaf_items, roots, None, 1, 1, 5, 1, 3, 3, ns=1)
    for g, mdl in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), mdl)


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------


def test_wrapper_runs_the_plain_loop_on_the_cpu(built):
    _, tdev, _, q = built
    qv, _, _, qf = query_arrays(tdev.metric, q)
    fn, _ = t_search.make_search_fn(tdev, 10, 300, traversal="xla")
    m = fn.margins(torch.from_numpy(qv), torch.from_numpy(qf))
    args = (m, tdev.node_table, tdev.leaf_items, fn.roots, fn.sk, fn.sk_exact, fn.pmax, tdev.max_leaf)
    kw = dict(q_cap=fn.q_cap, l_cap=fn.l_cap)
    n0 = tv.launches["traverse"]
    want = t_search._traverse_batch(*args, **kw)
    got = tv.traverse(*args, **kw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert tv.launches["traverse"] == n0  # the plain loop counts no launch
    with pytest.raises(ValueError, match="unsupported device"):
        tv.traverse(m.to("meta"), *args[1:], **kw)
