"""One on-disk format for both packages, and one device-state pack.

* An index built and persisted by `arroy_tpu` opens in the port with
  every array equal.
* An index built by the port opens in `arroy_tpu`, whose own
  `assert_validity` passes.
* `DeviceIndex.from_numpy` of the JAX package's `build_np` pack equals the
  port's own device index built from the same state.
* The port alone, copied away from the JAX package, builds and loads its
  own native container library.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu_torch.device import DeviceIndex

from . import torch_util  # noqa: F401  (single-threaded torch)

DIM = 16
ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def _jax_build(path, metric, x, n_trees=3):
    """The add/build sequence of `tests/util.build_db`, on a file-backed db."""
    db = arroy_tpu.Database(str(path))
    w = arroy_tpu.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        for j in range(len(x)):
            w.add_item(wtxn, j, x[j])
        w.builder(seed=42).n_trees(n_trees).build(wtxn)
    return db


def _torch_build(path, metric, x, n_trees=3):
    db = arroy_tpu_torch.Database(str(path), device="cpu")
    w = arroy_tpu_torch.Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=42).n_trees(n_trees).split_after(8).build(wtxn)
    return db


def _assert_states_equal(a, b):
    assert (a.dims, a.metric.name, str(a.version), a.generation) == (
        b.dims, b.metric.name, str(b.version), b.generation,
    )
    assert a.updated == b.updated
    for fn in ("rows", "norms", "extras", "slot_ids"):
        x, y = getattr(a.store, fn)(), getattr(b.store, fn)()
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for f in ("kind", "left", "right", "ptr", "normals", "aux"):
        x, y = getattr(a.forest, f), getattr(b.forest, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.forest.roots == b.forest.roots
    assert sorted(a.forest.leaves) == sorted(b.forest.leaves)
    for nid, ids in a.forest.leaves.items():
        np.testing.assert_array_equal(ids, b.forest.leaves[nid])
    assert (a.metadata is None) == (b.metadata is None)
    if a.metadata is not None:
        assert a.metadata.roots == b.metadata.roots
        assert a.metadata.dimensions == b.metadata.dimensions
        assert a.metadata.distance == b.metadata.distance
        np.testing.assert_array_equal(a.metadata.items.ids, b.metadata.items.ids)


@pytest.mark.parametrize("metric", ["euclidean", "binary quantized cosine"])
def test_jax_index_opens_in_port(tmp_path, metric):
    x = np.random.default_rng(0).standard_normal((300, DIM)).astype(np.float32)
    _jax_build(tmp_path, metric, x)
    jst = arroy_tpu.Database(str(tmp_path)).read().state(0)
    tdb = arroy_tpu_torch.Database(str(tmp_path), device="cpu")
    tst = tdb.read().state(0)
    _assert_states_equal(jst, tst)
    r = arroy_tpu_torch.Reader.open(tdb.read(), 0, tdb, metric=metric)
    r.assert_validity()
    assert r.n_trees() == 3 and r.n_items() == 300


@pytest.mark.parametrize("metric", ["dot-product", "binary quantized manhattan"])
def test_port_index_opens_in_jax(tmp_path, metric):
    x = np.random.default_rng(1).standard_normal((400, DIM)).astype(np.float32)
    _torch_build(tmp_path, metric, x)
    jdb = arroy_tpu.Database(str(tmp_path))
    r = arroy_tpu.Reader.open(jdb.read(), 0, jdb, metric=metric)
    r.assert_validity()
    assert r.n_trees() == 3 and r.n_items() == 400
    _assert_states_equal(
        jdb.read().state(0),
        arroy_tpu_torch.Database(str(tmp_path), device="cpu").read().state(0),
    )
    np.testing.assert_allclose(r.item_vector(7), arroy_tpu_torch.Database(
        str(tmp_path), device="cpu").read().state(0).store.get_vector(7))


@pytest.mark.parametrize("metric", ["cosine", "binary quantized euclidean"])
def test_from_numpy_matches_own_device_index(tmp_path, metric):
    x = np.random.default_rng(2).standard_normal((200, DIM)).astype(np.float32)
    db = _torch_build(tmp_path, metric, x)
    st = db.read().state(0)
    own = db.device_index(0, st)
    # the same persisted state read by the JAX package, packed by it
    jst = arroy_tpu.Database(str(tmp_path)).read().state(0)
    carried = DeviceIndex.from_numpy(
        JDeviceIndex.build_np(jst.metric, jst.dims, jst.store, jst.forest),
        st.metric, st.dims, "cpu",
    )
    for f in ("rows", "norms", "extras", "slot_to_id", "live", "kind", "left", "right",
              "ptr", "node_table", "normals", "aux", "leaf_off", "leaf_cnt", "leaf_items"):
        a, b = getattr(own, f), getattr(carried, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    assert own.slot_to_id.dtype == torch.int64
    if st.metric.binary:
        assert own.rows.dtype == torch.int32
    for f in ("roots", "n_nodes", "n_items", "max_leaf", "cap", "n_splits", "n_dead_pops"):
        assert getattr(own, f) == getattr(carried, f), f
    np.testing.assert_array_equal(own.slot_to_id_np, carried.slot_to_id_np)


@pytest.mark.parametrize("asset", ["v1_0_npy", "v1_1_zero_normal"])
def test_committed_assets_read_identically(asset):
    """Older generations (npy store, v1.1 container) load into the port
    exactly as the JAX package loads them (read-only: nothing is written)."""
    path = os.path.join(ASSETS, asset)
    jtx = arroy_tpu.Database(path).read()
    ttx = arroy_tpu_torch.Database(path, device="cpu").read()
    assert jtx.indexes() == ttx.indexes() and jtx.indexes()
    for index in jtx.indexes():
        _assert_states_equal(jtx.state(index), ttx.state(index))


def test_port_builds_its_own_container_alone(tmp_path):
    """A copy of `arroy_tpu_torch/` alone (no JAX package beside it) writes
    and reopens a container through the native library it compiled from
    its own source, not through the pure-Python fallback."""
    src = os.path.dirname(os.path.abspath(arroy_tpu_torch.__file__))
    shutil.copytree(src, tmp_path / "arroy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import numpy as np\n"
        "from arroy_tpu_torch import native\n"
        "assert native.native_available(), 'native container library did not load'\n"
        "a = {'x': np.arange(3000, dtype=np.float32).reshape(100, 30), 'y': np.ones(7, np.int64)}\n"
        "native.write_container('c.bin', a)\n"
        "c = native.Container('c.bin', verify=True)\n"
        "assert c._lib is not None and c._base is not None\n"
        "for k, v in a.items():\n"
        "    np.testing.assert_array_equal(c.array(k), v)\n"
        "c.close(force=True)\n"
        "print(native._so_path())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    so = out.stdout.strip().splitlines()[-1]
    assert so == str(tmp_path / "arroy_tpu_torch" / "_build" / "_container.so")
    assert os.path.exists(so)
