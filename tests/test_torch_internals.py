"""The port's embedder surface against the JAX package's: `internals`,
custom metrics (`register_metric`), `Writer.prepare_changing_distance`,
`utils.profiling` and `entry`.

The first seven tests mirror `tests/test_internals.py` on the port.  The
rest hold the port to the JAX package on the same inputs (numpy, from a
seed):
- leaf codecs: headers equal and rows byte for byte, on all 7 metrics;
- a custom metric: the JAX package builds a ``half-euclidean`` index and
  writes it to disk; the port opens that directory (its own class
  registered under the name), so both serve the identical forest.
  Searches: ids equal tie-aware, distances rtol 1e-5 with an absolute
  floor of 1e-6; a traversal row that differs must be due to the last bit
  of the port's own f32 margins, as in `tests/test_torch_traverse.py`.
"""

import json
import os

import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu import device as j_device
from arroy_tpu_torch import Database, Reader, Writer, internals
from arroy_tpu_torch import search as t_search
from arroy_tpu_torch.device import DeviceIndex
from arroy_tpu_torch.errors import SizeMismatch
from arroy_tpu_torch.metrics import Euclidean, metric_by_name

from . import test_internals as jax_internals_tests
from .test_torch_traverse import _arrays, _assert_same
from .torch_util import query_arrays, tie_aware_equal

METRICS = (
    "euclidean", "cosine", "dot-product", "manhattan",
    "binary quantized euclidean", "binary quantized manhattan", "binary quantized cosine",
)
M, DIM, TREES, K = 2000, 32, 6, 10


def test_craft_and_decode_leaf_f32():
    v = np.arange(6, dtype=np.float32) / 3.0
    leaf = internals.craft_leaf("euclidean", v)
    assert isinstance(leaf.header, internals.NodeHeaderEuclidean)
    assert leaf.metric_name == "euclidean"
    np.testing.assert_allclose(leaf.to_vector(), v)
    np.testing.assert_allclose(internals.decode_leaf("euclidean", leaf.vector, 6), v)


def test_craft_leaf_binary_quantized_roundtrip():
    v = np.array([0.5, -0.25, 0.0, -0.0, 3.0], np.float32)
    leaf = internals.craft_leaf("binary quantized cosine", v)
    assert isinstance(leaf.header, internals.NodeHeaderBinaryQuantizedCosine)
    assert leaf.vector.dtype == np.uint32
    # decode is the sign: >=0 (incl. +0.0) -> +1, negative (incl. -0.0) -> -1
    np.testing.assert_allclose(leaf.to_vector(), [1.0, -1.0, 1.0, -1.0, 1.0])
    np.testing.assert_array_equal(internals.pack_bits_np(v[None, :])[0], leaf.vector)


def test_craft_leaf_rejects_matrix():
    with pytest.raises(SizeMismatch):
        internals.craft_leaf("euclidean", np.zeros((2, 3), np.float32))


def test_raw_leaf_matches_store():
    db = Database(device="cpu")
    w = Writer(db, 0, 4, metric="cosine")
    vec = np.array([3.0, 0.0, 4.0, 0.0], np.float32)
    with db.write() as t:
        w.add_item(t, 7, vec)
        w.add_item(t, 8, -vec)
        w.builder(seed=1).n_trees(2).build(t)
    r = Reader.open(db.read(), 0, db, metric="cosine")
    leaf = internals.raw_leaf(r, 7)
    assert isinstance(leaf.header, internals.NodeHeaderCosine)
    assert leaf.header.norm == pytest.approx(5.0)
    np.testing.assert_allclose(leaf.to_vector(), vec)
    assert internals.raw_leaf(r, 99) is None


def test_raw_leaf_dot_product_carries_extra_dim():
    db = Database(device="cpu")
    w = Writer(db, 0, 3, metric="dot-product")
    with db.write() as t:
        w.add_item(t, 0, np.array([1.0, 0.0, 0.0], np.float32))
        w.add_item(t, 1, np.array([0.0, 2.0, 0.0], np.float32))
        w.builder(seed=1).n_trees(1).build(t)
    r = Reader.open(db.read(), 0, db, metric="dot-product")
    leaf = internals.raw_leaf(r, 0)
    assert isinstance(leaf.header, internals.NodeHeaderDotProduct)
    assert leaf.header.extra_dim > 0.0
    assert internals.raw_leaf(r, 1).header.extra_dim == pytest.approx(0.0)


def test_side_enum():
    rng = np.random.default_rng(0)
    seen = {internals.Side.random(rng) for _ in range(64)}
    assert seen == {internals.Side.Left, internals.Side.Right}


class HalfEuclidean(Euclidean):
    """A custom metric of the port: euclidean under another name."""

    name = "half-euclidean"


def _register_both():
    """The port's class and the JAX tests' own (registering one class
    twice is a no-op, so the JAX suite may run before or after)."""
    internals.register_metric(HalfEuclidean)
    arroy_tpu.internals.register_metric(jax_internals_tests.HalfEuclidean)


def test_register_metric_end_to_end(tmp_path):
    internals.register_metric(HalfEuclidean)
    assert metric_by_name("half-euclidean") is HalfEuclidean
    internals.register_metric(HalfEuclidean)
    with pytest.raises(ValueError):
        internals.register_metric(type("Clash", (Euclidean,), {"name": "half-euclidean"}))

    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    db = Database(str(tmp_path / "db"), device="cpu")
    w = Writer(db, 0, 8, metric="half-euclidean")
    with db.write() as t:
        w.add_items(t, np.arange(64, dtype=np.uint32), x)
        w.builder(seed=2).n_trees(3).build(t)

    db2 = Database(str(tmp_path / "db"), device="cpu")
    r = Reader.open(db2.read(), 0, db2, metric="half-euclidean")
    got = r.nns(5).by_item(0)
    assert got[0][0] == 0 and got[0][1] == pytest.approx(0.0, abs=1e-5)
    r.assert_validity()
    # no exact engine for a custom metric: "auto" serves the forest
    s = r.searcher(5)
    assert s.engine == "forest" and s.route == "traversal"
    assert s(x[:1])[0][0][0] == 0


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((16, DIM)).astype(np.float32)
    n = M + 48
    pa, pb = rng.integers(16, size=n), rng.integers(16, size=n)
    mask = rng.random((n, DIM)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    x[:M] += 0.05 * rng.standard_normal((M, DIM)).astype(np.float32)
    x[M:] += 0.5 * rng.standard_normal((48, DIM)).astype(np.float32)
    return x[:M], x[M:]


def _jax_index(path, metric, x):
    db = arroy_tpu.Database(str(path))
    w = arroy_tpu.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=7).n_trees(TREES).build(wtxn)
    return arroy_tpu.Reader.open(db.read(), 0, db, metric=metric)


@pytest.mark.parametrize("metric", METRICS)
def test_leaf_codecs_match_jax(tmp_path, metric):
    """craft / raw / decode give the JAX package's headers and rows byte
    for byte, on a crafted vector and on a JAX-written index's items."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, 13)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1.5]
    for v in x[:4]:
        jl, tl = arroy_tpu.internals.craft_leaf(metric, v), internals.craft_leaf(metric, v)
        assert type(tl.header).__name__ == type(jl.header).__name__
        assert vars(tl.header) == vars(jl.header)
        assert tl.vector.dtype == jl.vector.dtype and tl.vector.tobytes() == jl.vector.tobytes()
        assert (tl.dims, tl.metric_name) == (jl.dims, jl.metric_name)
        assert tl.to_vector().tobytes() == jl.to_vector().tobytes()
        assert (internals.decode_leaf(metric, tl.vector, 13).tobytes()
                == arroy_tpu.internals.decode_leaf(metric, jl.vector, 13).tobytes())
    assert internals.header_type(metric).__name__ == arroy_tpu.internals.header_type(metric).__name__
    db = arroy_tpu.Database(str(tmp_path))
    w = arroy_tpu.Writer(db, 0, 13, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(40, dtype=np.uint32) * 3, x)
        w.builder(seed=1).n_trees(2).build(wtxn)
    jr = arroy_tpu.Reader.open(db.read(), 0, db, metric=metric)
    tdb = Database(str(tmp_path), device="cpu")
    tr = Reader.open(tdb.read(), 0, tdb, metric=metric)
    for item in (0, 3, 57, 117, 4):
        jl, tl = arroy_tpu.internals.raw_leaf(jr, item), internals.raw_leaf(tr, item)
        if jl is None:
            assert tl is None
            continue
        assert vars(tl.header) == vars(jl.header)
        assert tl.vector.tobytes() == jl.vector.tobytes()


@pytest.fixture(scope="module")
def custom_index(tmp_path_factory):
    """(JAX Reader, port Reader, queries) over one JAX-built half-euclidean
    index that the port opens from disk."""
    _register_both()
    x, q = _corpus()
    path = tmp_path_factory.mktemp("half_euclidean")
    jr = _jax_index(path, "half-euclidean", x)
    tdb = Database(str(path), device="cpu")
    return jr, Reader.open(tdb.read(), 0, tdb, metric="half-euclidean"), q


def test_custom_metric_traversal_matches_jax(custom_index):
    """The JAX package's `build_np` pack through `DeviceIndex.from_numpy`:
    the port's traversal returns the JAX searcher's results."""
    jr, tr, q = custom_index
    jdev = jr._device()
    pack = j_device.DeviceIndex.build_np(jdev.metric, DIM, jr._state.store, jr._state.forest)
    tdev = DeviceIndex.from_numpy(pack, HalfEuclidean, DIM, "cpu")
    fn, route = t_search.make_search_fn(tdev, K, 600, rescore="exact", traversal="xla")
    assert route == "traversal"
    qv, qn, qe, qf = query_arrays(HalfEuclidean, q)
    ids, d = fn(*(torch.from_numpy(a) for a in (qv, qn, qe, qf)))
    tres = [[(int(i), float(v)) for i, v in zip(ri, rd)] for ri, rd in zip(ids[:, :K].numpy(), d[:, :K].numpy())]
    js = jr.searcher(K, search_k=600, engine="forest", traversal="xla", rescore="exact")
    _assert_same(jr, js(q), tres, fn, qv, qn, qe, qf)
    # the searcher over the port's own snapshot takes the same route
    s = tr.searcher(K, search_k=600, rescore="exact", traversal="xla")
    assert s.engine == "forest" and s.route == "traversal"
    _assert_same(jr, js(q), s(q), s.device_fn, qv, qn, qe, qf)


def test_custom_metric_default_searcher_rescores_each_candidate(custom_index):
    """A repair of the JAX package's generic branch: its default
    `searcher()` re-scores a custom metric with the matmul form of the
    dot product (ids by inner product, distances of 0 for a custom
    euclidean).  The port re-scores it per candidate with the metric's own
    formulas, so its default searcher answers as the JAX package's
    ``rescore="exact"`` one, with exact euclidean distances."""
    jr, tr, q = custom_index
    x, _ = _corpus()
    s = tr.searcher(K)
    assert (s.engine, s.route) == ("forest", "traversal")
    assert s.device_fn.rescore_mode(len(q)) == "exact"
    assert t_search.rescore_mode(HalfEuclidean, len(q), 10**6, 10, "matmul") == "exact"
    qv, qn, qe, qf = query_arrays(HalfEuclidean, q)
    got = s(q)
    _assert_same(jr, jr.searcher(K, rescore="exact")(q), got, s.device_fn, qv, qn, qe, qf)
    ids, d = _arrays(got)
    np.testing.assert_allclose(d, np.linalg.norm(x[ids] - q[:, None, :], axis=2), rtol=1e-5)


def test_custom_metric_probe_matches_jax(custom_index):
    """At the JAX package's re-score cut the port's probe returns its
    results.  The port's own cut for a custom metric is widened as an
    estimate's (its in-block score is a dot-product proxy); it keeps
    every candidate the JAX cut keeps, so recall is at least as high."""
    jr, tr, q = custom_index
    x, _ = _corpus()
    kw = dict(search_k=1200, engine="forest", traversal="probe", probe_trees=4, probe_block=16)
    s = tr.searcher(K, **kw)
    assert s.route == "probe"
    fn = s.device_fn
    jax_k2 = min(512, fn.tables.n_trees * fn.L * fn.tables.block)
    assert fn.k2 == min(t_search._next_pow2(max(3 * 512, 1200 // 2)),
                        fn.tables.n_trees * fn.L * fn.tables.block) > jax_k2
    wide_ids, wide_d = _arrays(s(q))
    jids, jd = _arrays(jr.searcher(K, **kw)(q))
    fn.k2 = jax_k2
    tids, td = _arrays(s(q))
    tie_aware_equal(tids, td, jids, jd, rtol=1e-5, atol=1e-6)
    exact = np.argsort(np.linalg.norm(x[None] - q[:, None], axis=2), axis=1)[:, :K]
    hits = [sum(len(set(a) & set(e)) for a, e in zip(ids, exact)) for ids in (wide_ids, jids)]
    assert hits[0] >= hits[1]
    np.testing.assert_allclose(wide_d, np.linalg.norm(x[wide_ids] - q[:, None], axis=2), rtol=1e-5)


def test_jax_written_custom_metric_opens_in_port(custom_index):
    jr, tr, q = custom_index
    assert tr.metric is HalfEuclidean
    assert (tr.n_items(), tr.n_trees(), str(tr.version())) == (
        jr.n_items(), jr.n_trees(), str(jr.version()))
    tr.assert_validity()
    got, want = tr.nns(5).by_item(17), jr.nns(5).by_item(17)
    assert got[0] == (17, 0.0)
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-5, atol=1e-6)
    assert tr.plot_internals_tree_nodes() == jr.plot_internals_tree_nodes()


def test_prepare_changing_distance(tmp_path):
    """test_writer.py:319 on the port, and the re-encoded items equal the
    JAX package's after the same change."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    readers = []
    for pkg, kw in ((arroy_tpu, {}), (arroy_tpu_torch, {"device": "cpu"})):
        db = pkg.Database(str(tmp_path / pkg.__name__), **kw)
        w = pkg.Writer(db, 0, 8, metric="euclidean")
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(50, dtype=np.uint32), x)
            w.builder(seed=1).n_trees(2).build(wtxn)
        with db.write() as wtxn:
            w2 = w.prepare_changing_distance(wtxn, "binary quantized cosine")
            assert w2.metric.name == "binary quantized cosine"
            w2.builder(seed=1).n_trees(2).build(wtxn)
        r2 = pkg.Reader.open(db.read(), 0, db, metric="binary quantized cosine")
        assert r2.n_items() == 50 and r2.n_trees() == 2
        r2.assert_validity()
        readers.append(r2)
    jr, tr = readers
    for i in range(50):
        assert tr.item_vector(i).tobytes() == jr.item_vector(i).tobytes()
        assert internals.raw_leaf(tr, i).vector.tobytes() == arroy_tpu.internals.raw_leaf(jr, i).vector.tobytes()
    with pytest.raises(arroy_tpu_torch.UnmatchingDistance):
        Reader.open(tr._db.read(), 0, tr._db, metric="euclidean")


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    from arroy_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("arroy.test.region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    (region,) = [e for e in events if e.get("name") == "arroy.test.region"]
    assert "request" in region["args"]


def test_entry_traverses_the_tiny_index():
    from arroy_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    ids, d = fn(*args)
    # each query is one of the index's items: its nearest is itself, at 0
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(8))
    np.testing.assert_allclose(d[:, 0].numpy(), 0.0, atol=1e-6)
    assert torch.all(d[:, 1:] >= d[:, :-1])
