"""The port's builds against the committed goldens and the JAX package.

Both packages draw every random choice of a build from the same threefry
keys at the same addresses, so a seed grows one forest in both:

* the twelve committed snapshots in `tests/snapshots/` (the JAX
  package's `tests/test_golden.py` scenarios) print byte for byte from
  the port's builds (`tests/torch_golden.py`), the mesh one at 8 shards
  and at 1;
* at 2,000 x 32, 4 trees, split_after 16, each metric's forest equals the
  JAX package's node for node (`torch_util.assert_forests_equal`: f32
  planes to rtol 1e-5, the rest bit-equal), also with the JAX grow's lane
  compaction forced small on both sides, which renumbers the stream's
  segments and lanes;
* inserts that route through splits without a normal take the JAX
  package's coins, and budget builds, fresh and incremental, grow the JAX
  package's forest;
* the f32 arithmetic the BQ planes hang on is XLA's to the last bit on
  operands whose exponents lie far apart: the centroid update's fused
  multiply-add (`metrics.fma32`) and the training sums
  (`metrics._xla_sum`).
"""

import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import arroy_tpu
import arroy_tpu.builder as j_builder
import arroy_tpu_torch
from arroy_tpu_torch import metrics as t_metrics
from arroy_tpu_torch import builder as t_builder
from arroy_tpu_torch import writer as t_writer
from arroy_tpu_torch.models.forest import KIND_SPLIT_NONE

from . import torch_golden
from . import torch_util  # noqa: F401  (single-threaded torch)
from .torch_util import assert_forests_equal

N, DIM, TREES, SPLIT = 2000, 32, 4, 16


@pytest.mark.parametrize("name", sorted(torch_golden.scenarios()))
def test_port_prints_the_committed_golden(name):
    assert torch_golden.scenarios()[name]("cpu") == torch_golden.snapshot(name)


def test_mesh_golden_at_one_shard():
    assert torch_golden.mesh_golden("cpu", shards=1) == torch_golden.snapshot("golden_mesh.txt")


def _far_apart(rng, shape):
    """f32 values whose exponents spread over 2**-30 .. 2**30."""
    m = rng.standard_normal(shape).astype(np.float32)
    return (m * np.ldexp(1.0, rng.integers(-30, 30, shape))).astype(np.float32)


def test_fma32_is_xlas_fused_multiply_add():
    """XLA's CPU backend contracts ``p * ic + k / nrm`` into one fused
    multiply-add.  Products on an f32 midpoint plus a far smaller term are
    where rounding the f64 sum to f32 (double rounding) misses it."""
    rng = np.random.default_rng(0)
    n = 20_000
    p = (rng.integers(1 << 23, 1 << 24, n) * 2.0**-23).astype(np.float32)
    ic = rng.integers(1, 12, n).astype(np.float32)
    c = (np.ldexp(1.0, -rng.integers(30, 70, n)) * rng.choice([-1, 1], n)).astype(np.float32)
    c[: n // 2] = _far_apart(rng, n // 2)
    want = np.asarray(jax.jit(lambda p, ic, c: p * ic + c)(p, ic, c))
    got = t_metrics.fma32(*map(torch.from_numpy, (p, ic, c))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    twice = (p.astype(np.float64) * ic + c).astype(np.float32)
    assert np.sum(twice != want) > 100  # the cases double rounding gets wrong are there


@pytest.mark.parametrize("n", [1, 4, 16, 32, 33, 64, 96, 100, 768, 1024, 1056, 2080])
def test_xla_sum_is_xlas_reduction(n):
    """`_xla_sum` with and without products against XLA's compiled sum on
    terms of far-apart exponents, within one window, across windows (the
    padding of a width off the window split between both ends) and past
    32 windows."""
    rng = np.random.default_rng(n)
    a, b = _far_apart(rng, (500, n)), _far_apart(rng, (500, n))
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=-1))(a, b))
    got = t_metrics._xla_sum(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(a))
    got = t_metrics._xla_sum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _build(pkg, metric, x, seed=7, n_trees=TREES, split_after=SPLIT, memory=None):
    db = pkg.Database() if pkg is arroy_tpu else pkg.Database(None, device="cpu")
    w = pkg.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        b = w.builder(seed=seed).n_trees(n_trees).split_after(split_after)
        if memory is not None:
            b.available_memory(memory)
        b.build(wtxn)
    return db.read().state(0).forest


@pytest.mark.parametrize("metric", torch_golden.METRICS, ids=torch_golden.slug)
def test_forest_equals_jax(metric):
    x = torch_golden.random_vectors(N, DIM, seed=3)
    fj = _build(arroy_tpu, metric, x)
    ft = _build(arroy_tpu_torch, metric, x)
    assert len(ft.leaves) > 200
    assert_forests_equal(ft, fj)


@pytest.mark.parametrize("metric", torch_golden.METRICS, ids=torch_golden.slug)
def test_forest_equals_jax_with_lane_compaction(metric, monkeypatch):
    """Frames of 1,024 lanes at least and a compaction floor of 512 (the
    JAX package's own compaction test settings) on both sides: the JAX
    grow compacts, and the port follows its renumbering."""
    monkeypatch.setattr(j_builder, "_COMPACT_MIN_LANES", 512)
    monkeypatch.setattr(j_builder, "_MARGIN_CHUNK", 1024)
    monkeypatch.setattr(t_builder, "_STREAM_COMPACT_LANES", 512)
    monkeypatch.setattr(t_builder, "_STREAM_FRAME_MIN", 1024)
    compactions = []
    compact = j_builder._compact_lanes

    def counted(*a, **k):
        compactions.append(k["p_pad2"])
        return compact(*a, **k)

    monkeypatch.setattr(j_builder, "_compact_lanes", counted)
    x = torch_golden.random_vectors(N, DIM, seed=3)
    fj = _build(arroy_tpu, metric, x)
    ft = _build(arroy_tpu_torch, metric, x)
    assert compactions
    assert_forests_equal(ft, fj)


def test_all_duplicates_equal_jax():
    """64 copies of one vector, split_after 2: every split falls back to
    random sides, some children come out empty, and the forest (empty
    leaves included) is the JAX package's."""
    x = np.repeat(torch_golden.random_vectors(1, 8, seed=4), 64, axis=0)
    fj = _build(arroy_tpu, "euclidean", x, seed=3, n_trees=2, split_after=2)
    ft = _build(arroy_tpu_torch, "euclidean", x, seed=3, n_trees=2, split_after=2)
    assert (ft.kind == KIND_SPLIT_NONE).sum() > 50
    assert any(len(v) == 0 for v in ft.leaves.values())
    assert_forests_equal(ft, fj)


def _twice(tmp_path, metric, x, split_after, seed=1):
    """A JAX-built index on disk, copied for each package."""
    src = tmp_path / "src"
    db = arroy_tpu.Database(str(src))
    w = arroy_tpu.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=seed).n_trees(3).split_after(split_after).build(wtxn)
    db.close()
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    return (arroy_tpu.Database(str(tmp_path / "jax")),
            arroy_tpu_torch.Database(str(tmp_path / "port"), device="cpu"))


def _rebuild(pkg, db, metric, dim, change, seed=5, split_after=8, memory=None):
    w = pkg.Writer(db, 0, dim, metric=metric)
    with db.write() as wtxn:
        change(w, wtxn)
        b = w.builder(seed=seed).n_trees(3).split_after(split_after)
        if memory is not None:
            b.available_memory(memory)
        b.build(wtxn)
    return db.read().state(0).forest


def test_insert_through_splits_without_a_normal(tmp_path):
    """A corpus with 120 copies of one vector: its splits fall back to
    random sides (normal-less splits).  New copies inserted afterwards
    route through those splits on the JAX package's coins, and the
    regrown forest equals the JAX package's."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    x[100:220] = x[5]
    jdb, tdb = _twice(tmp_path, "euclidean", x, split_after=8)
    f0 = tdb.read().state(0).forest
    assert (f0.kind == KIND_SPLIT_NONE).sum() >= 10
    fresh = np.concatenate([np.repeat(x[5:6], 40, 0), rng.standard_normal((20, 8))])
    fresh = fresh.astype(np.float32)

    def change(w, wtxn):
        w.add_items(wtxn, np.arange(300, 360, dtype=np.uint32), fresh)

    fj = _rebuild(arroy_tpu, jdb, "euclidean", 8, change)
    ft = _rebuild(arroy_tpu_torch, tdb, "euclidean", 8, change)
    assert t_writer.build_stats["routed_lanes"] == 60 * 3 and t_writer.build_stats["seeds"] > 0
    assert_forests_equal(ft, fj)


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized cosine"])
def test_budget_build_equals_jax(metric, monkeypatch):
    """A fresh build of 600 x 16 within 200 items of memory: skeletons
    from sampled batches, remainders routed in batches, and runs of
    nodes that fit a batch grown together in one pass (`grow_streams`),
    which hands out node ids as the JAX package's one-by-one grows do."""
    runs = []
    grow = t_writer.grow_streams
    monkeypatch.setattr(t_writer, "grow_streams",
                        lambda ctx, s: runs.append(len(s)) or grow(ctx, s))
    sd = arroy_tpu_torch.metrics.resolve_metric(metric).storage_dim(16)
    x = torch_golden.random_vectors(600, 16, seed=9)
    memory = 200 * (4 + 4 * sd)
    fj = _build(arroy_tpu, metric, x, n_trees=2, split_after=40, memory=memory)
    ft = _build(arroy_tpu_torch, metric, x, n_trees=2, split_after=40, memory=memory)
    assert t_writer.build_stats["streaming"] and max(runs) > 1
    assert_forests_equal(ft, fj)


def test_budget_incremental_build_equals_jax(tmp_path):
    """Inserts under a budget route in batches of the budget, each keyed by
    its offset; leaves that overflow regrow in budget mode."""
    x = torch_golden.random_vectors(450, 8, seed=12)
    jdb, tdb = _twice(tmp_path, "euclidean", x[:300], split_after=24)

    def change(w, wtxn):
        w.add_items(wtxn, np.arange(300, 450, dtype=np.uint32), x[300:])
        w.del_items(wtxn, np.arange(0, 300, 9))

    memory = 60 * (4 + 4 * 8)
    fj = _rebuild(arroy_tpu, jdb, "euclidean", 8, change, split_after=24, memory=memory)
    ft = _rebuild(arroy_tpu_torch, tdb, "euclidean", 8, change, split_after=24, memory=memory)
    assert t_writer.build_stats["streaming"] and t_writer.build_stats["routed_lanes"] == 450
    assert t_writer.build_stats["seeds"] > 0
    assert_forests_equal(ft, fj)
