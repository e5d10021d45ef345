"""The port's on-disk format upgrades against the JAX package's.

The ten tests of `tests/test_upgrade.py` run on the port, on copies of
the committed assets `tests/assets/v1_0_npy` (written at format 1.0.0,
npy layout) and `tests/assets/v1_1_zero_normal` (1.1.0, with split nodes
whose stored normal row is all zero).  Then both packages upgrade their
own copy of each asset and the states must be equal array by array
(forest kinds, children, pointers, normals and biases, leaves, the item
store and the metadata), and an index upgraded by either package opens
in the other and answers as it does there (ids tie-aware, distances
rtol 1e-5).
"""

import json
import os
import shutil

import numpy as np
import pytest

import arroy_tpu
from arroy_tpu import upgrade as j_upgrade
from arroy_tpu_torch import Database, Reader, UnknownVersion, Writer
from arroy_tpu_torch.cli import upgrade as upgrade_cli
from arroy_tpu_torch.models.forest import KIND_SPLIT, KIND_SPLIT_NONE
from arroy_tpu_torch.upgrade import upgrade_all, upgrade_index
from arroy_tpu_torch.version import CURRENT_VERSION, V1_0_0, V1_1_0, Version

from .util import random_vectors

ASSET = os.path.join(os.path.dirname(__file__), "assets", "v1_0_npy")
ASSET_V1_1 = os.path.join(os.path.dirname(__file__), "assets", "v1_1_zero_normal")
INDEXES = ((0, "euclidean"), (1, "binary quantized cosine"))


def _copy_asset(tmp_path, src=ASSET, name="db"):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _db(path):
    return Database(path, device="cpu")


def _zero_normal_splits(st) -> list[int]:
    f = st.forest
    split = np.nonzero(f.kind == KIND_SPLIT)[0]
    if f.normals is None or not split.size:
        return []
    rows = f.ptr[split]
    zero = ~np.any(f.normals[rows] != 0, axis=1)
    return [int(n) for n in split[zero]]


def test_v1_0_asset_reads_before_upgrade(tmp_path):
    db = _db(_copy_asset(tmp_path))
    for idx, metric in INDEXES:
        r = Reader.open(db.read(), idx, db, metric=metric)
        assert r.version() == V1_0_0
        r.assert_validity()
        got = r.nns(5).by_item(3)
        assert got and got[0][1] == pytest.approx(0.0)
        assert 3 in [i for i, d in got if d == pytest.approx(0.0)]


def test_upgrade_v1_0_to_current(tmp_path):
    path = _copy_asset(tmp_path)
    db = _db(path)
    before = {
        idx: Reader.open(db.read(), idx, db, metric=m).nns(10).by_item(7) for idx, m in INDEXES
    }
    assert upgrade_all(db) == [0, 1]

    db2 = _db(path)
    for idx, metric in INDEXES:
        st = db2.read().state(idx)
        assert st.version == CURRENT_VERSION
        gen_dir = os.path.join(path, f"idx_{idx:05d}", f"gen_{st.generation:08d}")
        meta = json.load(open(os.path.join(gen_dir, "meta.json")))
        assert meta["store"] == "container"
        assert meta["version"] == str(CURRENT_VERSION)
        assert os.path.exists(os.path.join(gen_dir, "state.atc"))
        r = Reader.open(db2.read(), idx, db2, metric=metric)
        r.assert_validity()
        assert r.nns(10).by_item(7) == before[idx]
    assert upgrade_all(db2) == []


def test_v1_1_asset_reads_before_upgrade(tmp_path):
    db = _db(_copy_asset(tmp_path, ASSET_V1_1))
    for idx, metric in INDEXES:
        r = Reader.open(db.read(), idx, db, metric=metric)
        assert r.version() == V1_1_0
        r.assert_validity()
        assert _zero_normal_splits(db.read().state(idx)), "asset lost its legacy pattern"
        got = r.nns(5).by_item(2)
        assert got and got[0][1] == pytest.approx(0.0)


def test_upgrade_v1_1_zero_normals_to_none(tmp_path):
    """Zero-normal KIND_SPLIT nodes become KIND_SPLIT_NONE, their rows leave
    the normals matrix, and nns() answers as before (distances equal, ids
    equal wherever a distance is unique: the asset's duplicates tie)."""
    path = _copy_asset(tmp_path, ASSET_V1_1)
    db = _db(path)
    before, legacy = {}, {}
    for idx, metric in INDEXES:
        st = db.read().state(idx)
        legacy[idx] = _zero_normal_splits(st)
        assert legacy[idx]
        r = Reader.open(db.read(), idx, db, metric=metric)
        before[idx] = {
            "nns": [r.nns(10).by_item(i) for i in (0, 2, 7)],
            "rows": len(st.forest.normals),
            "none": int(np.sum(st.forest.kind == KIND_SPLIT_NONE)),
        }
    assert upgrade_all(db) == [0, 1]

    db2 = _db(path)
    for idx, metric in INDEXES:
        st = db2.read().state(idx)
        assert st.version == CURRENT_VERSION
        assert _zero_normal_splits(st) == []
        for nid in legacy[idx]:
            assert int(st.forest.kind[nid]) == KIND_SPLIT_NONE
        assert len(st.forest.normals) == before[idx]["rows"] - len(legacy[idx])
        assert int(np.sum(st.forest.kind == KIND_SPLIT_NONE)) == before[idx]["none"] + len(legacy[idx])
        live = np.nonzero(st.forest.kind == KIND_SPLIT)[0]
        assert np.all(st.forest.ptr[live] == np.arange(live.size))
        r = Reader.open(db2.read(), idx, db2, metric=metric)
        r.assert_validity()
        after = [r.nns(10).by_item(i) for i in (0, 2, 7)]
        for rows_a, rows_b in zip(after, before[idx]["nns"]):
            da = [d for _, d in rows_a]
            assert da == pytest.approx([d for _, d in rows_b])
            for (ia, d1), (ib, _) in zip(rows_a, rows_b):
                if da.count(d1) == 1:
                    assert ia == ib, (d1, ia, ib)
        assert sum(t.dummy_normals for t in r.stats().tree_stats) >= len(legacy[idx])
    assert upgrade_all(db2) == []


def test_upgrade_chain_v1_0_runs_both_steps(tmp_path):
    path = _copy_asset(tmp_path)
    upgrade_all(_db(path))
    for idx in (0, 1):
        st = _db(path).read().state(idx)
        assert st.version == CURRENT_VERSION
        assert _zero_normal_splits(st) == []


def test_upgraded_index_keeps_working_incrementally(tmp_path):
    path = _copy_asset(tmp_path)
    db = _db(path)
    upgrade_index(db, 0)
    w = Writer(db, 0, 8)
    x = random_vectors(4, 8, seed=9)
    with db.write() as t:
        for i in range(4):
            w.add_item(t, 100 + i, x[i])
        w.del_item(t, 0)
        w.builder(seed=5).build(t)
    r = Reader.open(db.read(), 0, db)
    assert r.version() == CURRENT_VERSION
    r.assert_validity()
    assert not r.contains_item(0)
    assert r.contains_item(103)


def _built(path, seed, n):
    x = random_vectors(n, 4, seed=seed)
    db = _db(path)
    w = Writer(db, 0, 4)
    with db.write() as wtxn:
        for i in range(n):
            w.add_item(wtxn, i, x[i])
        w.builder(seed=1).build(wtxn)
    return db


def test_reader_reports_version(tmp_path):
    db = _built(str(tmp_path / "db"), 1, 30)
    assert Reader.open(db.read(), 0, db).version() == CURRENT_VERSION


def test_upgrade_noop_at_current(tmp_path):
    db = _built(str(tmp_path / "db"), 2, 30)
    upgrade_index(db, 0)
    r = Reader.open(db.read(), 0, db)
    assert r.version() == CURRENT_VERSION
    r.assert_validity()


def test_future_format_rejected(tmp_path):
    path = str(tmp_path / "db")
    _built(path, 3, 10)
    manifest_path = os.path.join(path, "MANIFEST.json")
    m = json.load(open(manifest_path))
    m["version"] = "99.0.0"
    json.dump(m, open(manifest_path, "w"))
    with pytest.raises(UnknownVersion):
        _db(path)


def test_version_ordering():
    assert Version(0, 9, 9) < Version(1, 0, 0) < Version(1, 0, 1)
    assert str(Version(1, 2, 3)) == "1.2.3"
    assert Version.parse("4.5.6") == Version(4, 5, 6)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _state_arrays(st) -> dict:
    """Every array and scalar of an index state, by name (numpy)."""
    f, s = st.forest, st.store
    out = {
        "kind": f.kind, "left": f.left, "right": f.right, "ptr": f.ptr,
        "normals": f.normals, "aux": f.aux, "roots": np.asarray(f.roots),
        "leaf_nodes": np.asarray(sorted(f.leaves)),
        "rows": s.rows(), "norms": s.norms(), "extras": s.extras(), "slot_ids": s.slot_ids(),
        "version": str(st.version), "dims": st.dims, "metric": st.metric.name,
        "updated": sorted(st.updated),
    }
    for nid in sorted(f.leaves):
        out[f"leaf_{nid}"] = f.leaves[nid]
    md = st.metadata
    out["metadata"] = (md.dimensions, list(md.roots), md.distance)
    out["metadata_items"] = np.asarray(md.items.ids)
    return out


def _assert_states_equal(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sa.keys() == sb.keys()
    for name in sa:
        if isinstance(sa[name], np.ndarray):
            assert sa[name].dtype == sb[name].dtype, name
            np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)
        else:
            assert sa[name] == sb[name], name


@pytest.mark.parametrize("asset", [ASSET, ASSET_V1_1], ids=["v1_0_npy", "v1_1_zero_normal"])
def test_both_packages_upgrade_to_the_same_state(tmp_path, asset):
    jpath = _copy_asset(tmp_path, asset, "jax")
    tpath = _copy_asset(tmp_path, asset, "torch")
    assert j_upgrade.upgrade_all(arroy_tpu.Database(jpath)) == [0, 1]
    # the port's CLI tool runs upgrade_all
    upgrade_cli.main(["--db", tpath, "--device", "cpu"])
    jdb, tdb = arroy_tpu.Database(jpath), _db(tpath)
    for idx, _ in INDEXES:
        _assert_states_equal(tdb.read().state(idx), jdb.read().state(idx))


def _assert_same_answers(jr, tr, items):
    for i in items:
        got, want = tr.nns(10).by_item(i), jr.nns(10).by_item(i)
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-5, atol=1e-6)
        ds = [d for _, d in want]
        for (ia, d1), (ib, _) in zip(got, want):
            if sum(np.isclose(ds, d1, rtol=1e-5, atol=1e-6)) == 1:
                assert ia == ib


@pytest.mark.parametrize("upgrader", ["jax", "torch"])
def test_upgraded_index_opens_in_the_other_package(tmp_path, upgrader):
    path = _copy_asset(tmp_path, ASSET_V1_1)
    if upgrader == "jax":
        j_upgrade.upgrade_all(arroy_tpu.Database(path))
    else:
        upgrade_all(_db(path))
    jdb, tdb = arroy_tpu.Database(path), _db(path)
    for idx, metric in INDEXES:
        jr = arroy_tpu.Reader.open(jdb.read(), idx, jdb, metric=metric)
        tr = Reader.open(tdb.read(), idx, tdb, metric=metric)
        assert str(jr.version()) == str(tr.version()) == str(CURRENT_VERSION)
        jr.assert_validity()
        tr.assert_validity()
        _assert_same_answers(jr, tr, (0, 2, 7))


@pytest.mark.parametrize("idx,metric,dtype", [
    (0, "euclidean", "f32"), (0, "euclidean", "bf16"), (1, "binary quantized cosine", "bq"),
])
def test_split_none_nodes_pack_as_in_jax(tmp_path, idx, metric, dtype):
    """On the upgraded 1.1 asset (legacy zero normals now KIND_SPLIT_NONE),
    the device pack and the probe's block tables equal the JAX package's
    array by array, and the probe answers as the JAX package's does."""
    from arroy_tpu import device as j_device
    from arroy_tpu import probe as j_probe
    from arroy_tpu_torch import probe as t_probe
    from arroy_tpu_torch.device import DeviceIndex

    path = _copy_asset(tmp_path, ASSET_V1_1)
    upgrade_all(_db(path))
    jdb, tdb = arroy_tpu.Database(path), _db(path)
    js, ts = jdb.read().state(idx), tdb.read().state(idx)
    assert np.any(ts.forest.kind == KIND_SPLIT_NONE)
    want = j_device.DeviceIndex.build_np(js.metric, js.dims, js.store, js.forest)
    got = DeviceIndex.build_np(ts.metric, ts.dims, ts.store, ts.forest)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key
    want = j_probe.build_tables_np(js.metric, js.dims, js.store, js.forest, 4, 16, dtype)
    got = t_probe.build_tables_np(ts.metric, ts.dims, ts.store, ts.forest, 4, 16, dtype)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].tobytes() == w.tobytes(), key
        else:
            assert got[key] == w, key
    kw = dict(search_k=64, engine="forest", traversal="probe", probe_trees=4, probe_block=16,
              probe_dtype=dtype)
    jr = arroy_tpu.Reader.open(jdb.read(), idx, jdb, metric=metric)
    tr = Reader.open(tdb.read(), idx, tdb, metric=metric)
    q = np.stack([tr.item_vector(i) for i in (0, 2, 7)])
    s = tr.searcher(10, **kw)
    assert s.route == "probe"
    for got_row, want_row in zip(s(q), jr.searcher(10, **kw)(q)):
        np.testing.assert_allclose([d for _, d in got_row], [d for _, d in want_row],
                                   rtol=1e-5, atol=1e-6)
