"""The port's forest builder, held by invariants.

The port draws the JAX package's threefry stream, so its forests equal
the JAX package's from the same seed on any device (the byte-equal
goldens in `tests/snapshots/` and the parity of
`tests/test_torch_golden.py` hold that).  Every forest must also pass
both packages' `assert_validity`, keep every leaf within `split_after`,
have the requested tree count and finite normals, and repeat exactly for
the same seed.
"""

import numpy as np
import pytest

import arroy_tpu
from arroy_tpu_torch import Database, NeedBuild, Reader, Writer
from arroy_tpu_torch.models.forest import KIND_LEAF, KIND_SPLIT

from . import torch_util  # noqa: F401  (single-threaded torch)

N, DIM, TREES, SPLIT = 2000, 32, 4, 16


def _build(metric, x, path=None, seed=7, n_trees=TREES, split_after=SPLIT):
    db = Database(None if path is None else str(path), device="cpu")
    w = Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        b = w.builder(seed=seed).n_trees(n_trees)
        if split_after is not None:
            b.split_after(split_after)
        b.build(wtxn)
    return db, w


def _corpus(seed=0, n=N, d=DIM):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize(
    "metric", ["euclidean", "cosine", "dot-product", "binary quantized euclidean"]
)
def test_forest_invariants(tmp_path, metric):
    x = _corpus()
    db, _ = _build(metric, x, path=tmp_path)
    r = Reader.open(db.read(), 0, db, metric=metric)
    r.assert_validity()
    f = r._state.forest
    assert r.n_trees() == TREES and len(f.roots) == TREES
    leaves = [f.leaves[int(n)] for n in np.nonzero(f.kind == KIND_LEAF)[0]]
    assert max(len(v) for v in leaves) <= SPLIT
    assert sum(len(v) for v in leaves) == TREES * N
    n_split = int(np.count_nonzero(f.kind == KIND_SPLIT))
    assert f.normals.shape[0] == n_split and f.aux.shape[0] == n_split
    if not r.metric.binary:
        assert np.isfinite(f.normals).all()
    assert np.isfinite(f.aux).all()
    assert all(t.descendants >= 1 and t.depth >= 2 for t in r.stats().tree_stats)
    # the JAX package reads the persisted forest and agrees it is valid
    jdb = arroy_tpu.Database(str(tmp_path))
    arroy_tpu.Reader.open(jdb.read(), 0, jdb, metric=metric).assert_validity()


def test_same_seed_same_forest():
    x = _corpus(1)
    forests = []
    for _ in range(2):
        db, _ = _build("euclidean", x, seed=11)
        forests.append(db.read().state(0).forest)
    a, b = forests
    for f in ("kind", "left", "right", "ptr", "normals", "aux"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.roots == b.roots and sorted(a.leaves) == sorted(b.leaves)
    for nid in a.leaves:
        np.testing.assert_array_equal(a.leaves[nid], b.leaves[nid])
    db, _ = _build("euclidean", x, seed=12)
    assert not np.array_equal(db.read().state(0).forest.left, a.left)


def test_tiny_corpus_fast_path():
    x = _corpus(2, n=10, d=DIM)
    db, w = _build("cosine", x, split_after=None)  # split_after defaults to dims
    r = Reader.open(db.read(), 0, db, metric="cosine")
    r.assert_validity()
    f = r._state.forest
    assert r.n_trees() == 1 and list(f.leaves) == [0]
    np.testing.assert_array_equal(f.leaves[0], np.arange(10))
    assert not w.need_build(db.read())
    got = r.searcher(3)(x[:2])
    assert [g[0][0] for g in got] == [0, 1]


def test_incremental_rebuild_not_ported():
    """An index with roots and pending updates rebuilds incrementally (the
    name dates from before the port had that build); an aborted txn leaves
    the committed index as it was, and a committed update demands a build."""
    x = _corpus(3)
    db, w = _build("euclidean", x)
    with db.write() as wtxn:
        w.add_item(wtxn, N + 1, x[0])
        assert w.need_build(wtxn)
        w.builder(seed=1).split_after(SPLIT).available_memory(1 << 20).build(wtxn)
        assert not w.need_build(wtxn)
        wtxn.abort()
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert r.n_items() == N
    with db.write() as wtxn:
        w.del_item(wtxn, 5)
    with pytest.raises(NeedBuild):
        Reader.open(db.read(), 0, db)
    with db.write() as wtxn:
        w.add_item(wtxn, N + 1, x[0])
        w.builder(seed=1).n_trees(TREES).split_after(SPLIT).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert r.n_items() == N and r.n_trees() == TREES
    assert r.nns(1).search_k(10**5).by_item(N + 1)[0][1] == 0.0


def test_tree_count_changes_without_updates():
    x = _corpus(4)
    db, w = _build("euclidean", x, n_trees=3)
    for n in (5, 2):  # grow missing trees, then delete extra ones
        with db.write() as wtxn:
            w.builder(seed=n).n_trees(n).split_after(SPLIT).build(wtxn)
        r = Reader.open(db.read(), 0, db)
        r.assert_validity()
        assert r.n_trees() == n


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized euclidean"])
def test_jax_traversal_searches_port_forest(tmp_path, metric):
    """The reference's best-first traversal finds the neighbours in a
    port-built forest, so split sides agree with the normals' margin signs
    (a JAX-built forest of this corpus reaches 0.98 at this search_k)."""
    x = _corpus(5)
    _build(metric, x, path=tmp_path, n_trees=8)
    jdb = arroy_tpu.Database(str(tmp_path))
    r = arroy_tpu.Reader.open(jdb.read(), 0, jdb, metric=metric)
    q = x[:32] + 0.05 * np.random.default_rng(6).standard_normal((32, DIM)).astype(np.float32)
    got = r.nns(10).search_k(2000).by_vectors(q)
    exact = r.exact_by_vectors(q, 10)
    hits = sum(len({i for i, _ in g} & {i for i, _ in e}) for g, e in zip(got, exact))
    assert hits / (32 * 10) >= 0.95
