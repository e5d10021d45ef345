"""The port's sharded single-forest build (`arroy_tpu_torch.parallel.build`).

`tests/test_sharded_build.py`'s four tests on the port: one forest
grown with the per-level compute sharded over a mesh must be valid,
bit-identical for any mesh size (1 and 8 shards, 4 metrics), serve at
normal recall and take incremental updates.  Then parity: the port's
mesh build takes the JAX package's 32-bit ``seed_base`` (the last word
of ``key_data(fold_in(key(seed), 0xB111D))``) from its own threefry key
and equals the JAX package's node for node (kinds, children, plane rows,
leaves, roots bit-equal; split planes to rtol 1e-5 with a 1e-6 absolute
floor, f32 arithmetic in another order).
"""

import jax
import numpy as np
import pytest

import arroy_tpu
from arroy_tpu.parallel.mesh import make_mesh as j_make_mesh
from arroy_tpu_torch import Database, Reader, Writer, prng
from arroy_tpu_torch import writer as t_writer
from arroy_tpu_torch.parallel.mesh import make_mesh

from . import torch_util  # noqa: F401  (single-threaded torch)
from .torch_util import recall
from .util import random_vectors

METRICS = ["euclidean", "cosine", "dot-product", "binary quantized cosine"]


def _build(x, mesh, metric="euclidean", n_trees=4, split_after=32, seed=42, pkg=None):
    m, d = x.shape
    db = Database(device="cpu") if pkg is None else pkg.Database()
    w = (Writer if pkg is None else pkg.Writer)(db, 0, d, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        b = w.builder(seed=seed).n_trees(n_trees).split_after(split_after)
        if mesh is not None:
            b.mesh(mesh)
        b.build(wtxn)
    return db


def _forests_equal(fa, fb, rtol=0.0, atol=0.0):
    for key in ("kind", "left", "right", "ptr"):
        np.testing.assert_array_equal(getattr(fa, key), getattr(fb, key))
    np.testing.assert_allclose(fa.normals, fb.normals, rtol=rtol, atol=atol)
    np.testing.assert_allclose(fa.aux, fb.aux, rtol=rtol, atol=atol)
    assert set(fa.leaves) == set(fb.leaves)
    for k in fa.leaves:
        np.testing.assert_array_equal(fa.leaves[k], fb.leaves[k])
    assert fa.roots == fb.roots


@pytest.mark.parametrize("metric", METRICS)
def test_mesh_size_invariance(metric):
    x = random_vectors(600, 16, seed=5)
    f1 = _build(x, make_mesh(1, device="cpu"), metric, 2, 8).read().state(0).forest
    db8 = _build(x, make_mesh(8, device="cpu"), metric, 2, 8)
    _forests_equal(f1, db8.read().state(0).forest)  # bit for bit
    assert t_writer.build_stats["streaming"] and t_writer.build_stats["seeds"] == 2


def test_sharded_build_validity_and_recall():
    x = random_vectors(2000, 16, seed=0)
    db = _build(x, make_mesh(8, device="cpu"), n_trees=4, split_after=32)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    got = np.array([[i for i, _ in row] for row in r.searcher(10, search_k=2000)(x[:32])])
    exact = np.array([[i for i, _ in row] for row in r.exact_by_vectors(x[:32], 10)])
    assert recall(got, exact) >= 0.95


def test_sharded_build_duplicate_vectors_random_fallback():
    # all-identical vectors never split by a hyperplane: the 0.99
    # imbalance fallback must kick in (KIND_SPLIT_NONE) and terminate
    x = np.ones((100, 8), np.float32)
    db = _build(x, make_mesh(4, device="cpu"), n_trees=2, split_after=4)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert sum(t.dummy_normals for t in r.stats().tree_stats) > 0


def test_sharded_build_then_incremental_update():
    # a mesh-built forest takes the ordinary incremental path
    x = random_vectors(500, 8, seed=2)
    db = _build(x, make_mesh(8, device="cpu"), n_trees=2, split_after=16)
    w = Writer(db, 0, 8)
    with db.write() as wtxn:
        w.del_item(wtxn, 0)
        w.add_item(wtxn, 1000, x[0])
        w.builder(seed=7).n_trees(2).build(wtxn)  # single-device incremental pass
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert not r.contains_item(0)
    assert r.contains_item(1000)
    assert r.nns(5).search_k(10**6).by_item(1000)[0][0] == 1000
    # and a second mesh build updates it incrementally too
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(2000, 2100, dtype=np.uint32), random_vectors(100, 8, seed=3))
        w.builder(seed=8).n_trees(2).split_after(16).mesh(make_mesh(4, device="cpu")).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert r.n_items() == 600 and t_writer.build_stats["routed_lanes"] == 200


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_build_matches_jax(metric):
    """`grow_trees_sharded` draws the JAX package's seed_base from the
    build's key and grows the JAX package's sharded forest, 8 shards each."""
    seed = 42
    kd = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), 0xB111D)))
    assert int(prng.key_data(prng.fold_in(prng.key(seed), 0xB111D))[-1]) == int(kd.ravel()[-1])
    x = random_vectors(600, 16, seed=5)
    fj = _build(x, j_make_mesh(8), metric, 2, 8, seed, pkg=arroy_tpu).read().state(0).forest
    ft = _build(x, make_mesh(8, device="cpu"), metric, 2, 8, seed).read().state(0).forest
    assert len(ft.leaves) > 100
    _forests_equal(ft, fj, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_on_cpu():
    """`entry.dryrun_multichip`, the counterpart of
    ``__graft_entry__.dryrun_multichip``: its five checks on 4 CPU shards."""
    from arroy_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
