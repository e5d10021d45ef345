"""The port's incremental build against the JAX package's.

Each metric's base index is built once with the JAX package and written
to disk; every test copies that directory twice, makes the same change
through each package's `Writer` and rebuilds.  Both packages draw the
same threefry stream, so the two forests must be equal node for node,
as `tests/test_golden.dump_index` prints them: after the delete pass
with its collapse, routing through planes that all have a normal, leaves
put back in place, and also where leaves overflow and regrow (the seeds,
node ids and item sets, are checked on their own too).

The second half ports `tests/test_incremental.py`'s cases to the port
alone (its own forests, invariants and search results).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import builder as j_builder
from arroy_tpu.metrics import resolve_metric as j_resolve_metric
from arroy_tpu.models.forest import Forest as JForest
from arroy_tpu.models.forest import NodeIdAllocator as JNodeIdAllocator
from arroy_tpu_torch import NeedBuild, Reader, Writer, builder as t_builder, prng, writer as t_writer
from arroy_tpu_torch.models.forest import KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE, NodeIdAllocator

from . import torch_util  # noqa: F401  (single-threaded torch)
from .torch_util import assert_forests_equal
from .test_golden import _snap_path, dump_index
from .util import random_vectors

DIM, N, TREES = 8, 200, 3
#: route_items and the delete-only build on four metrics: three f32 ones
#: (dot-product with its extra) and one on packed words
METRICS = ("euclidean", "cosine", "dot-product", "binary quantized euclidean")


def _jax_write(path, metric, x, n_trees=TREES, seed=1, split_after=None):
    db = arroy_tpu.Database(str(path))
    w = arroy_tpu.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        b = w.builder(seed=seed).n_trees(n_trees)
        if split_after is not None:
            b.split_after(split_after)
        b.build(wtxn)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """metric -> directory of a JAX-written index of N random items."""
    made = {}

    def get(metric):
        if metric not in made:
            path = tmp_path_factory.mktemp(metric.replace(" ", "_").replace("-", "_"))
            _jax_write(path, metric, random_vectors(N, DIM, seed=11))
            made[metric] = path
        return made[metric]

    return get


def _both(src, tmp_path):
    """(JAX database, port database) on two copies of `src`."""
    a, b = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return arroy_tpu.Database(str(a)), arroy_tpu_torch.Database(str(b), device="cpu")


def _rebuild(pkg, db, metric, change, seed=5, n_trees=TREES, split_after=None):
    """Apply `change(writer, wtxn)`, rebuild, and return a Reader."""
    w = pkg.Writer(db, 0, DIM, metric=metric)
    with db.write() as wtxn:
        change(w, wtxn)
        b = w.builder(seed=seed)
        if n_trees is not None:
            b.n_trees(n_trees)
        if split_after is not None:
            b.split_after(split_after)
        b.build(wtxn)
    return pkg.Reader.open(db.read(), 0, db, metric=metric)


def _leaf_sizes_ok(r, split_after):
    f = r._state.forest
    leaves = [f.leaves[int(n)] for n in np.nonzero(f.kind == KIND_LEAF)[0]]
    assert max(len(v) for v in leaves) <= split_after


# ---------------------------------------------------------------------------
# the same forest as the JAX package where no random draw is involved
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_delete_only_matches_jax(tmp_path, base, metric):
    jdb, tdb = _both(base(metric), tmp_path)
    gone = np.arange(0, 150, 3)

    def change(w, wtxn):
        w.del_items(wtxn, gone)

    jr = _rebuild(arroy_tpu, jdb, metric, change)
    tr = _rebuild(arroy_tpu_torch, tdb, metric, change)
    assert t_writer.build_stats["deleted"] == len(gone)
    assert t_writer.build_stats["seeds"] == 0
    assert dump_index(tr) == dump_index(jr)
    tr.assert_validity()


def test_delete_collapse_golden(tmp_path):
    """`tests/test_golden.build_delete_collapse_golden`: the JAX package
    builds the first index; the port makes the mass delete and its build
    must print the committed snapshot."""
    _jax_write(tmp_path, "euclidean", random_vectors(128, 8, seed=31), n_trees=2, seed=64)
    db = arroy_tpu_torch.Database(str(tmp_path), device="cpu")
    r = _rebuild(
        arroy_tpu_torch, db, "euclidean",
        lambda w, wtxn: w.del_items(wtxn, [i for i in range(128) if i % 4]),
        seed=64, n_trees=2,
    )
    assert dump_index(r) == open(_snap_path("golden_delete_collapse.txt")).read()


@pytest.mark.parametrize("keep", [0, 5], ids=["everything", "down_to_5"])
def test_delete_nearly_everything_matches_jax(tmp_path, base, keep):
    """Down to the tiny-corpus path: one leaf, or nothing at all."""
    jdb, tdb = _both(base("euclidean"), tmp_path)

    def change(w, wtxn):
        w.del_items(wtxn, np.arange(keep, N))

    jr = _rebuild(arroy_tpu, jdb, "euclidean", change, n_trees=None)
    tr = _rebuild(arroy_tpu_torch, tdb, "euclidean", change, n_trees=None)
    assert dump_index(tr) == dump_index(jr)
    assert tr.n_items() == keep
    if keep:
        assert tr.n_trees() == 1
        tr.assert_validity()
    else:
        assert tr.nns(5).by_vector(random_vectors(1, DIM, seed=3)[0]) == []


def _contexts(jst, tst, split_after=DIM):
    """The JAX and port BuildContexts over the same persisted state."""
    jrows, jnorms, jextras = jst.store.device_arrays()
    jctx = j_builder.BuildContext(
        metric=jst.metric, dims=DIM, split_after=split_after, rows_dev=jrows,
        extras_dev=jextras, hnorms_dev=jnorms, slot_to_id=jst.store.slot_ids(),
        forest=jst.forest, alloc=JNodeIdAllocator(jst.forest.used_node_ids()),
    )
    trows, tnorms, textras = tst.store.device_arrays("cpu")
    tctx = t_builder.BuildContext(
        metric=tst.metric, dims=DIM, split_after=split_after, device=torch.device("cpu"),
        rows_dev=trows, extras_dev=textras, hnorms_dev=tnorms,
        slot_to_id=tst.store.slot_ids(), forest=tst.forest,
        alloc=NodeIdAllocator(tst.forest.used_node_ids()),
        staging_normals=[tst.forest.normals],
        staging_aux=[np.asarray(tst.forest.aux, np.float32)],
        staging_rows=int(tst.forest.normals.shape[0]),
    )
    return jctx, tctx


def _as_sets(routed):
    return {nid: np.sort(np.concatenate(ls)).tolist() for nid, ls in routed.items()}


def _entries(st):
    """Every live slot from every root, and from the first split under the
    first root (a walk that starts inside a tree)."""
    f = st.forest
    slots = st.store.slots_of(st.store.ids())
    entries = [(r, slots) for r in f.roots]
    inner = int(f.left[f.roots[0]])
    entries.append((inner, slots[::2]))
    return entries


@pytest.mark.parametrize("metric", METRICS)
def test_route_items_matches_jax(tmp_path, base, metric, monkeypatch):
    jdb, tdb = _both(base(metric), tmp_path)
    jst, tst = jdb.read().state(0), tdb.read().state(0)
    f = tst.forest
    # no plane without a normal on these forests, so no walk draws a coin
    assert not (f.kind == KIND_SPLIT_NONE).any()
    assert f.kind[f.roots[0]] == KIND_SPLIT
    jctx, tctx = _contexts(jst, tst)
    entries = _entries(tst)
    want = _as_sets(
        j_builder.route_items(
            jctx, jnp.asarray(jst.forest.normals), jst.forest.aux, entries, jax.random.key(0)
        )
    )
    key = prng.key(0)
    got = _as_sets(
        t_builder.route_items(tctx, tctx.staging_matrix_dev(), tctx.staging_aux_np(), entries, key)
    )
    assert got == want
    assert all(f.kind[nid] == KIND_LEAF for nid in got)
    assert sum(len(v) for v in got.values()) == sum(len(s) for _, s in entries)
    # small chunks land every lane where one chunk does
    monkeypatch.setattr(t_builder, "_ROUTE_CHUNK", 97)
    small = _as_sets(
        t_builder.route_items(tctx, tctx.staging_matrix_dev(), tctx.staging_aux_np(), entries, key)
    )
    assert small == got


def test_route_items_draws_coins_at_normal_less_splits():
    """A split without a normal sends each lane to a side from the build's
    threefry key: both sides are taken, the same seed repeats them, and
    each lane takes the JAX package's side."""
    from arroy_tpu_torch.metrics import resolve_metric
    from arroy_tpu_torch.models.forest import Forest

    f = Forest()
    f.put_split(0, 1, 2, None)
    f.put_leaf(1, np.arange(0, 2, dtype=np.uint32))
    f.put_leaf(2, np.arange(2, 4, dtype=np.uint32))
    rows = torch.zeros((64, DIM))
    ctx = t_builder.BuildContext(
        metric=resolve_metric("euclidean"), dims=DIM, split_after=DIM,
        device=torch.device("cpu"), rows_dev=rows, extras_dev=torch.zeros(64),
        hnorms_dev=torch.zeros(64), slot_to_id=np.arange(64), forest=f,
        alloc=NodeIdAllocator(f.used_node_ids()),
    )

    def run(seed):
        return _as_sets(
            t_builder.route_items(ctx, ctx.staging_matrix_dev(), ctx.staging_aux_np(),
                                  [(0, np.arange(64))], prng.key(seed))
        )

    got = run(3)
    assert sorted(got) == [1, 2] and sum(len(v) for v in got.values()) == 64
    assert run(3) == got and run(4) != got
    jf = JForest()
    jf.put_split(0, 1, 2, None)
    jf.put_leaf(1, np.arange(0, 2, dtype=np.uint32))
    jf.put_leaf(2, np.arange(2, 4, dtype=np.uint32))
    jctx = j_builder.BuildContext(
        metric=j_resolve_metric("euclidean"), dims=DIM, split_after=DIM,
        rows_dev=jnp.zeros((64, DIM)), extras_dev=jnp.zeros(64), hnorms_dev=jnp.zeros(64),
        slot_to_id=np.arange(64), forest=jf, alloc=JNodeIdAllocator(jf.used_node_ids()),
    )
    want = j_builder.route_items(jctx, jnp.zeros((1, DIM)), np.zeros(1, np.float32),
                                 [(0, np.arange(64))], jax.random.key(3))
    assert got == _as_sets(want)


def test_insert_without_overflow_matches_jax(tmp_path, base):
    """New items routed into leaves with room, so no leaf regrows: each is
    a copy of an item whose leaf in every tree holds fewer than
    `split_after` items, one per leaf.  The same forest as the JAX
    package's, node for node."""
    jdb, tdb = _both(base("euclidean"), tmp_path)
    st = tdb.read().state(0)
    f = st.forest
    used, picked = set(), []
    for item in range(N):
        leaves = [_leaf_of(f, r, item) for r in f.roots]
        if all(len(f.leaves[n]) < DIM and n not in used for n in leaves):
            picked.append(item)
            used.update(leaves)
    assert len(picked) >= 4
    copies = np.stack([st.store.get_vector(i) for i in picked])

    def change(w, wtxn):
        w.add_items(wtxn, np.arange(N, N + len(picked), dtype=np.uint32), copies)

    jr = _rebuild(arroy_tpu, jdb, "euclidean", change)
    tr = _rebuild(arroy_tpu_torch, tdb, "euclidean", change)
    assert t_writer.build_stats["seeds"] == 0
    assert t_writer.build_stats["routed_lanes"] == len(picked) * TREES
    assert dump_index(tr) == dump_index(jr)
    tr.assert_validity()
    for item, new in zip(picked, range(N, N + len(picked))):
        for r in tr._state.forest.roots:
            assert _leaf_of(tr._state.forest, r, new) == _leaf_of(f, r, item)


def _leaf_of(f, root, item):
    for n in _subtree(f, root):
        if f.kind[n] == KIND_LEAF and item in f.leaves[n]:
            return n
    raise KeyError(item)


def _subtree(f, nid):
    out, stack = set(), [int(nid)]
    while stack:
        n = stack.pop()
        out.add(n)
        if f.kind[n] in (KIND_SPLIT, KIND_SPLIT_NONE):
            stack += [int(f.left[n]), int(f.right[n])]
    return out


def _node_record(f, nid):
    k = int(f.kind[nid])
    if k == KIND_LEAF:
        return (k, f.leaves[nid].tolist())
    row = f.normals[f.ptr[nid]].tolist() if k == KIND_SPLIT else None
    aux = float(f.aux[f.ptr[nid]]) if k == KIND_SPLIT else None
    return (k, int(f.left[nid]), int(f.right[nid]), row, aux)


def test_regrowth_seeds_match_jax(tmp_path, base, monkeypatch):
    """Add + overwrite + delete, with leaves that overflow: both packages
    regrow the same seeds (node ids and item sets); every node outside
    the regrown subtrees is equal, and the regrown subtrees are too, node
    for node (the grows draw the same threefry stream); the port's forest
    keeps the invariants."""
    jdb, tdb = _both(base("euclidean"), tmp_path)
    seeds = {}

    def recorder(pkg, grow):
        def wrapped(ctx, group, key):
            seeds.setdefault(pkg, {}).update(
                (int(nid), np.sort(ctx.slot_to_id[np.asarray(s)]).tolist()) for nid, s in group
            )
            return grow(ctx, group, key)

        return wrapped

    monkeypatch.setattr(arroy_tpu.writer, "grow_trees", recorder("jax", arroy_tpu.writer.grow_trees))
    monkeypatch.setattr(t_writer, "grow_trees", recorder("port", t_writer.grow_trees))
    fresh = random_vectors(60, DIM, seed=13)

    def change(w, wtxn):
        w.add_items(wtxn, np.arange(N, N + 40, dtype=np.uint32), fresh[:40])
        w.add_items(wtxn, np.arange(10, 30, dtype=np.uint32), fresh[40:])  # overwrite
        w.del_items(wtxn, np.arange(100, 110))

    jr = _rebuild(arroy_tpu, jdb, "euclidean", change)
    tr = _rebuild(arroy_tpu_torch, tdb, "euclidean", change)
    assert seeds["port"] and seeds["port"] == seeds["jax"]
    stats = t_writer.build_stats
    assert stats["seeds"] == len(seeds["port"]) and stats["valve_items"] == 0
    assert stats["seed_items"] == sum(len(v) for v in seeds["port"].values())
    jf, tf = jr._state.forest, tr._state.forest
    regrown_j = set().union(*(_subtree(jf, n) for n in seeds["jax"]))
    regrown_t = set().union(*(_subtree(tf, n) for n in seeds["port"]))
    outside = set(int(i) for i in tf.used_node_ids()) - regrown_t
    assert outside == set(int(i) for i in jf.used_node_ids()) - regrown_j
    assert len(outside) > len(regrown_t)
    for nid in sorted(outside):
        assert _node_record(tf, nid) == _node_record(jf, nid), nid
    assert tf.roots == jf.roots
    assert regrown_t == regrown_j
    assert_forests_equal(tf, jf)
    tr.assert_validity()
    _leaf_sizes_ok(tr, DIM)
    assert tr.n_items() == N + 40 - 10


# ---------------------------------------------------------------------------
# tests/test_incremental.py's cases, on the port alone
# ---------------------------------------------------------------------------


def _port_db(x, n_trees, seed=1, metric="euclidean", ids=None):
    db = arroy_tpu_torch.Database(device="cpu")
    w = Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)) if ids is None else ids, x)
        w.builder(seed=seed).n_trees(n_trees).build(wtxn)
    return db, w


def test_incremental_add_items():
    x = random_vectors(300, 8, seed=1)
    db, w = _port_db(x[:200], 4)
    with db.write() as wtxn:
        for i in range(200, 300):
            w.add_item(wtxn, i, x[i])
        w.builder(seed=2).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    assert r.n_items() == 300
    r.assert_validity()
    _leaf_sizes_ok(r, 8)
    assert r.nns(5).by_item(250)[0][0] == 250


def test_incremental_delete_items():
    x = random_vectors(300, 8, seed=2)
    db, w = _port_db(x, 4)
    with db.write() as wtxn:
        for i in range(100):
            w.del_item(wtxn, i)
        w.builder(seed=2).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    assert r.n_items() == 200
    r.assert_validity()
    got = r.nns(300).search_k(10**6).by_item(150)
    assert all(i >= 100 for i, _ in got) and len(got) == 200


def test_delete_down_to_single_descendant():
    db, w = _port_db(random_vectors(100, 8, seed=3), 4)
    with db.write() as wtxn:
        w.del_items(wtxn, np.arange(5, 100))
        w.builder(seed=2).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    assert r.n_items() == 5 and r.n_trees() == 1
    r.assert_validity()


def test_untouched_subtrees_keep_node_ids():
    db, w = _port_db(random_vectors(400, 8, seed=5), 2)
    f1 = db.read().state(0).forest
    used1, roots1 = set(f1.used_node_ids().tolist()), list(f1.roots)
    with db.write() as wtxn:
        w.add_item(wtxn, 400, random_vectors(1, 8, seed=6)[0])
        w.builder(seed=2).n_trees(2).build(wtxn)
    r2 = Reader.open(db.read(), 0, db)
    used2 = set(r2._state.forest.used_node_ids().tolist())
    assert list(r2._state.forest.roots) == roots1
    assert len(used1 & used2) / len(used1) > 0.8
    r2.assert_validity()


def test_node_id_recycling():
    x = random_vectors(300, 4, seed=7)
    db, w = _port_db(x, 4)
    max1 = int(db.read().state(0).forest.used_node_ids().max())
    with db.write() as wtxn:
        w.del_items(wtxn, np.arange(150))
        w.builder(seed=2).n_trees(4).build(wtxn)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(150), x[:150])
        w.builder(seed=3).n_trees(4).build(wtxn)
    r3 = Reader.open(db.read(), 0, db)
    assert int(r3._state.forest.used_node_ids().max()) <= max1 + int(max1 * 0.5) + 8
    r3.assert_validity()


def test_abort_rolls_back():
    db, w = _port_db(random_vectors(50, 8, seed=9), 2)
    wtxn = db.write()
    w.del_item(wtxn, 0)
    wtxn.abort()
    assert Reader.open(db.read(), 0, db).n_items() == 50  # no NeedBuild


def test_cancelled_incremental_build_leaves_the_index(tmp_path):
    from arroy_tpu_torch.errors import BuildCancelled

    x = random_vectors(200, 8, seed=9)
    db, w = _port_db(x[:150], 3)
    before = dump_index(Reader.open(db.read(), 0, db))
    with pytest.raises(BuildCancelled):
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(150, 200), x[150:])
            w.builder(seed=2).n_trees(3).cancel(lambda: True).build(wtxn)
    assert dump_index(Reader.open(db.read(), 0, db)) == before


def test_overwrite_vector_moves_item():
    x = random_vectors(200, 8, seed=10)
    db, w = _port_db(x, 4)
    with db.write() as wtxn:
        w.add_item(wtxn, 0, x[150])
        w.builder(seed=2).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    got = r.nns(2).search_k(10**6).by_item(150)
    assert {i for i, _ in got} == {0, 150}


def test_dot_product_preprocess_recomputed_incrementally():
    x = random_vectors(100, 8, seed=20)
    db, w = _port_db(x, 3, metric="dot-product")
    with db.write() as wtxn:
        w.add_item(wtxn, 500, x[1] * 50.0)  # a new largest norm
        w.builder(seed=2).n_trees(3).build(wtxn)
    # the extra of every item changed, so the mirror uploaded all of them
    assert t_writer.build_stats["mirror_rows"] == db.read().state(0).store.capacity()
    r = Reader.open(db.read(), 0, db, metric="dot-product")
    r.assert_validity()
    got = r.nns(5).search_k(10**6).by_vector(x[0])
    exact = r.exact_by_vectors(x[0][None], 5)[0]
    assert [i for i, _ in got] == [i for i, _ in exact]
    assert got[0][0] == 500


def test_route_chunking_matches_single_chunk(monkeypatch):
    """Inserts routed in chunks of 256 lanes land on the leaves one chunk
    finds (no coin is drawn: every plane has a normal)."""

    def run(chunk):
        if chunk:
            monkeypatch.setattr(t_builder, "_ROUTE_CHUNK", chunk)
        x = random_vectors(400, 8, seed=31)
        db, w = _port_db(x[:300], 3, seed=7)
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(300, 400), x[300:])
            w.builder(seed=8).n_trees(3).build(wtxn)
        r = Reader.open(db.read(), 0, db)
        r.assert_validity()
        f = r._state.forest
        return {nid: tuple(f.leaves[nid].tolist()) for nid in f.leaves}

    assert run(None) == run(256)


def test_need_build_after_a_committed_update():
    db, w = _port_db(random_vectors(60, 8, seed=4), 2)
    with db.write() as wtxn:
        w.del_item(wtxn, 5)
    with pytest.raises(NeedBuild):
        Reader.open(db.read(), 0, db)
    with db.write() as wtxn:
        w.builder(seed=3).n_trees(2).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    assert r.n_items() == 59 and 5 not in r._state.forest.subtree_items(r._state.forest.roots[0])
