"""The port's memory-budgeted build and its patched device mirror.

The mirror tests are `tests/test_incremental.py`'s three, on the port's
`ItemStore.device_arrays`, with the rows each sync uploads read from
`models.items.mirror_rows_uploaded`.  The budget tests hold the
streaming build by its invariants, by the JAX package's budget scenario
(`tests/test_golden.build_budget_golden`, whose committed snapshot the
port's build prints byte for byte: both draw the same threefry stream)
and by recall against a resident build of the same corpus.
"""

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer, builder as t_builder, writer as t_writer
from arroy_tpu_torch.metrics import resolve_metric
from arroy_tpu_torch.models import items as t_items
from arroy_tpu_torch.models.forest import KIND_LEAF, Forest, NodeIdAllocator
from arroy_tpu_torch.models.items import ItemStore

from . import torch_util  # noqa: F401  (single-threaded torch)
from .torch_golden import dump_index, snapshot
from .torch_util import recall
from .util import random_vectors


def _mirror_equal(s, arrays):
    r, n, e = (a.numpy() for a in arrays)
    host = s.rows().view(np.int32) if s.metric.binary else s.rows()
    np.testing.assert_array_equal(r, host)
    np.testing.assert_array_equal(n, s.norms())
    np.testing.assert_array_equal(e, s.extras())


# ---------------------------------------------------------------------------
# the patched device mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized cosine"])
def test_device_mirror_incremental_sync(metric):
    """The patched mirror equals a fresh upload after puts, deletes,
    growth in capacity and clone divergence, and uploads only what changed."""
    s = ItemStore(resolve_metric(metric), 40)
    rng = np.random.default_rng(3)
    s.put_many(np.arange(10), rng.standard_normal((10, 40)).astype(np.float32))
    _mirror_equal(s, s.device_arrays("cpu"))  # full upload
    assert t_items.mirror_rows_uploaded == s.capacity()
    _mirror_equal(s, s.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == 0  # nothing changed

    # one overwrite and one delete: two rows of 64
    s.put(2, rng.standard_normal(40).astype(np.float32))
    s.delete(7)
    _mirror_equal(s, s.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == 2

    # growth in capacity pads the mirror; the fresh slots arrive as dirty ones
    s.put_many(np.arange(100, 120), rng.standard_normal((20, 40)).astype(np.float32))
    cap0 = 64
    assert s.capacity() == cap0
    s.put_many(np.arange(200, 250), rng.standard_normal((50, 40)).astype(np.float32))
    assert s.capacity() > cap0
    s.device_arrays("cpu")
    s.put(5, rng.standard_normal(40).astype(np.float32))
    s.put_many(np.arange(300, 330), rng.standard_normal((30, 40)).astype(np.float32))
    grown = s.capacity()
    _mirror_equal(s, s.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == 31 and grown > 96

    # clone divergence: each clone matches itself; the second clone's
    # epoch no longer matches the mirror, so it uploads everything
    a, b = s.clone(), s.clone()
    a.put(0, np.ones(40, np.float32))
    _mirror_equal(a, a.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == 1
    b.put(0, np.full(40, 2.0, np.float32))
    _mirror_equal(b, b.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == b.capacity()
    _mirror_equal(s, s.device_arrays("cpu"))


def test_device_mirror_patch_leaves_older_snapshots_alone():
    """A reader of an older snapshot holds the mirror's previous tensors:
    a patch must not write into them."""
    s = ItemStore(resolve_metric("euclidean"), 4)
    s.put_many(np.arange(64), np.ones((64, 4), np.float32))
    old = s.device_arrays("cpu")
    s.put(3, np.full(4, 5.0, np.float32))
    new = s.device_arrays("cpu")
    assert t_items.mirror_rows_uploaded == 1
    assert torch.all(old[0] == 1.0) and new[0][3, 0] == 5.0


def test_device_mirror_idempotent_readd_is_free():
    """Identical re-adds dirty nothing; a changed row, norm or extra does."""
    s = ItemStore(resolve_metric("euclidean"), 4)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    s.put_many(np.arange(50), x)
    s.device_arrays("cpu")
    assert not s._dirty

    ep = s._epoch
    s.put_many(np.arange(50), x.copy())
    assert not s._dirty and s._epoch == ep
    s.device_arrays("cpu")
    assert t_items.mirror_rows_uploaded == 0

    # duplicate ids resolve last-wins, here to the old content: clean
    s.put_many(np.array([3, 3], np.uint32), np.stack([x[3] + 1.0, x[3]]))
    assert not s._dirty
    s.put_many(np.array([5]), x[5:6] + 1.0)
    assert s._dirty == {int(s.slots_of(np.array([5]))[0])}
    _mirror_equal(s, s.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == 1

    # extras set by a preprocess and reset to 0 by a re-add count as a change
    sl = s.slots_of(np.arange(50))
    s.set_preprocess(s.norms()[sl], np.ones(50, np.float32), sl)
    s.device_arrays("cpu")
    s.put_many(np.arange(50), x)
    assert len(s._dirty) == 50
    _mirror_equal(s, s.device_arrays("cpu"))


@pytest.mark.parametrize("n_dirty, patched", [(15, True), (16, False), (40, False)])
def test_device_mirror_quarter_dirty_uploads_everything(n_dirty, patched):
    """Under a quarter of the slots dirty the sync patches them; from a
    quarter on it uploads the whole matrix.  Either way it equals the host."""
    s = ItemStore(resolve_metric("euclidean"), 4)
    rng = np.random.default_rng(9)
    s.put_many(np.arange(64), rng.standard_normal((64, 4)).astype(np.float32))
    s.device_arrays("cpu")
    s.put_many(np.arange(n_dirty), rng.standard_normal((n_dirty, 4)).astype(np.float32))
    _mirror_equal(s, s.device_arrays("cpu"))
    assert t_items.mirror_rows_uploaded == (n_dirty if patched else 64)


def test_incremental_build_uploads_only_changed_rows():
    x = random_vectors(300, 8, seed=4)
    db = Database(device="cpu")
    w = Writer(db, 0, 8)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(256), x[:256])
        w.builder(seed=1).n_trees(3).build(wtxn)
    with db.write() as wtxn:
        w.del_items(wtxn, np.arange(10))
        w.add_items(wtxn, np.arange(20, 30), x[256:266])
        w.add_items(wtxn, np.arange(256, 266), x[266:276])  # into the 10 freed slots
        w.builder(seed=2).n_trees(3).build(wtxn)
    assert t_writer.build_stats["mirror_rows"] == 20
    # the same ids re-added with the same bytes: the mirror uploads nothing
    with db.write() as wtxn:
        st = wtxn.state(0)
        ids = st.store.ids()
        w.add_items(wtxn, ids, np.stack([st.store.get_vector(i) for i in ids]))
        w.builder(seed=3).n_trees(3).build(wtxn)
    assert t_writer.build_stats["mirror_rows"] == 0
    assert t_writer.build_stats["deleted"] == len(ids)
    Reader.open(db.read(), 0, db).assert_validity()


# ---------------------------------------------------------------------------
# the memory-budgeted build
# ---------------------------------------------------------------------------


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((24, d)).astype(np.float32)
    pa, pb = rng.integers(24, size=n), rng.integers(24, size=n)
    mask = rng.random((n, d)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    return x + 0.1 * rng.standard_normal((n, d)).astype(np.float32)


def _build(x, n_trees, memory=None, split_after=None, seed=1, metric="euclidean"):
    db = Database(device="cpu")
    w = Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        b = w.builder(seed=seed).n_trees(n_trees)
        if memory is not None:
            b.available_memory(memory)
        if split_after is not None:
            b.split_after(split_after)
        b.build(wtxn)
    return db, w, Reader.open(db.read(), 0, db, metric=metric)


def _invariants(r, n_trees, split_after):
    r.assert_validity()
    f = r._state.forest
    assert r.n_trees() == n_trees
    leaves = [f.leaves[int(n)] for n in np.nonzero(f.kind == KIND_LEAF)[0]]
    assert max(len(v) for v in leaves) <= split_after
    assert t_writer.build_stats["valve_items"] == 0


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "binary quantized euclidean"])
def test_budget_build_streams_below_the_corpus(metric):
    x = random_vectors(300, 16, seed=5)
    sd = resolve_metric(metric).storage_dim(16)
    _, _, r = _build(x, 3, memory=64 * (4 + 4 * sd), metric=metric)
    stats = t_writer.build_stats
    assert stats["streaming"] and stats["budget_items"] == 64
    assert stats["mirror_rows"] == 0
    _invariants(r, 3, 16)
    # a budget at or above the corpus keeps the resident path
    _build(x, 3, memory=300 * (4 + 4 * sd), metric=metric)
    assert not t_writer.build_stats["streaming"]


def test_budget_golden_scenario():
    """`build_budget_golden`'s scenario (96 items, 2 trees, 32 items of
    budget) and `available_memory(0)`, whose floor is dims + 1 items, as
    the JAX package runs them: both stream and keep the invariants, and
    the first prints the committed snapshot."""
    x = random_vectors(96, 8, seed=31)
    for memory, items in ((32 * 8 * 4, 28), (0, 9)):
        _, _, r = _build(x, 2, memory=memory, seed=64)
        assert t_writer.build_stats["streaming"]
        assert t_writer.build_stats["budget_items"] == items
        assert r.n_items() == 96
        _invariants(r, 2, 8)
        if items == 28:
            assert dump_index(r) == snapshot("golden_budget.txt")


def test_budget_recall_near_resident():
    x = _clustered(2064, 16, seed=8)
    x, q = x[:2000], x[2000:]
    recalls = []
    for memory in (None, 250 * (4 + 4 * 16)):
        _, _, r = _build(x, 6, memory=memory, split_after=16, seed=3)
        assert t_writer.build_stats["streaming"] == (memory is not None)
        got = [[i for i, _ in r.nns(10).search_k(400).by_vector(v)] for v in q]
        exact = [[i for i, _ in e] for e in r.exact_by_vectors(q, 10)]
        recalls.append(recall(np.array(got), np.array(exact)))
    _invariants(r, 6, 16)
    assert recalls[1] >= recalls[0] - 0.05, recalls


def test_budget_incremental_build_routes_in_batches():
    """An incremental build under a budget routes its inserts in batches
    of budget_items and uploads only their rows."""
    x = random_vectors(400, 8, seed=6)
    db, w, _ = _build(x[:300], 3)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(300, 400), x[300:])
        w.del_items(wtxn, np.arange(0, 300, 7))
        w.builder(seed=4).n_trees(3).available_memory(30 * (4 + 4 * 8)).build(wtxn)
    stats = t_writer.build_stats
    assert stats["streaming"] and stats["budget_items"] == 30
    assert stats["routed_lanes"] == 100 * 3 and stats["mirror_rows"] == 0
    r = Reader.open(db.read(), 0, db)
    _invariants(r, 3, 8)
    assert r.n_items() == 400 - len(range(0, 300, 7))


def test_device_view_and_ids_to_slots():
    """Streaming mode uploads the unique rows a call names and remaps
    slots onto them; an id absent from the store raises."""
    met = resolve_metric("euclidean")
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    slot_to_id = np.array([5, -1, 7, 9, 11, -1, 13, 15, 17, 19], np.int64)
    ctx = t_builder.BuildContext(
        metric=met, dims=4, split_after=4, device=torch.device("cpu"), rows_dev=None,
        extras_dev=None, hnorms_dev=None, slot_to_id=slot_to_id, forest=Forest(),
        alloc=NodeIdAllocator(np.empty(0, np.int64)), budget_items=3, rows_np=rows,
        extras_np=np.zeros(10, np.float32), hnorms_np=np.ones(10, np.float32),
    )
    assert ctx.streaming
    r, e, h, remap, ids = ctx.device_view(np.array([8, 2, 8, 3]))
    np.testing.assert_array_equal(r.numpy(), rows[[2, 3, 8]])
    np.testing.assert_array_equal(remap(np.array([8, 2, 3])), [2, 0, 1])
    np.testing.assert_array_equal(ids, [7, 9, 17])
    np.testing.assert_array_equal(ctx.ids_to_slots(np.array([19, 5, 13])), [9, 0, 6])
    with pytest.raises(KeyError):
        ctx.ids_to_slots(np.array([5, 6]))
    # the staged normals' device copy grows by the chunks staged since
    ctx.stage_chunk(np.ones((2, 4), np.float32), np.zeros(2))
    assert ctx.staging_matrix_dev().shape == (2, 4)
    ctx.stage_chunk(torch.zeros((3, 4)), np.zeros(3))
    m = ctx.staging_matrix_dev()
    assert m.shape == (5, 4) and m[:2].eq(1).all() and m[2:].eq(0).all()
    assert ctx.staging_matrix_dev() is m
