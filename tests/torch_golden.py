"""The committed golden scenarios, built by the PyTorch port.

`tests/test_golden.py` pins twelve builds of the JAX package as text
dumps in `tests/snapshots/` (the reference's insta snapshots,
src/tests/writer.rs:296-1015).  The port draws the JAX package's threefry
stream, so the same scenarios built by the port, on any device, must
print the same bytes.  This module holds the scenarios, `dump_index` and
`random_vectors` for the port alone: it imports no JAX, so a machine
without it (the card's) can check the goldens too
(`python3 chip_smoke.py`, phase 12).
"""

from __future__ import annotations

import os

import numpy as np

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch.parallel.mesh import make_mesh

SNAP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "snapshots")

METRICS = (
    "euclidean",
    "manhattan",
    "cosine",
    "dot-product",
    "binary quantized euclidean",
    "binary quantized manhattan",
    "binary quantized cosine",
)


def random_vectors(m: int, d: int, seed: int = 0) -> np.ndarray:
    """`tests/util.random_vectors`: standard normal f32 rows from a seed."""
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def dump_index(reader: Reader) -> str:
    """`tests/test_golden.dump_index` on a port `Reader`: metadata, then
    every node by id (a split's normal as the rounded sum of its row)."""
    st = reader._state
    f = st.forest
    lines = [
        f"dims={st.metadata.dimensions} distance={st.metadata.distance}",
        f"items={list(st.metadata.items)}",
        f"roots={list(st.metadata.roots)}",
        f"version={st.version}",
    ]
    for nid in sorted(int(i) for i in f.used_node_ids()):
        k = int(f.kind[nid])
        if k == 2:  # leaf
            lines.append(f"node {nid}: Descendants({[int(x) for x in f.leaves[nid]]})")
        elif k == 1:
            lines.append(
                f"node {nid}: SplitPlaneNormal(None, left={int(f.left[nid])}, "
                f"right={int(f.right[nid])})"
            )
        else:
            row = f.normals[f.ptr[nid]]
            sig = float(np.round(np.sum(np.asarray(row, np.float64)), 4))
            lines.append(
                f"node {nid}: SplitPlaneNormal(sig={sig}, aux="
                f"{float(np.round(f.aux[f.ptr[nid]], 4))}, "
                f"left={int(f.left[nid])}, right={int(f.right[nid])})"
            )
    return "\n".join(lines)


def slug(metric: str) -> str:
    return metric.replace(" ", "_").replace("-", "_")


def _build(x, device, metric="euclidean", n_trees=2, seed=64):
    """`tests/util.build_db`: items added one by one, then one build."""
    db = Database(None, device=device)
    w = Writer(db, 0, x.shape[1], metric=metric)
    with db.write() as wtxn:
        for j in range(len(x)):
            w.add_item(wtxn, j, x[j])
        w.builder(seed=seed).n_trees(n_trees).build(wtxn)
    return db, w, Reader.open(db.read(), 0, db, metric=metric)


def metric_golden(metric: str, device="cpu") -> str:
    """64 items x 8 dims, 2 trees, seed 64."""
    return dump_index(_build(random_vectors(64, 8, seed=31), device, metric)[2])


def incremental_golden(device="cpu") -> str:
    """16 added and 8 deleted, rebuilt with seed 65."""
    db, w, _ = _build(random_vectors(64, 8, seed=31), device)
    extra = random_vectors(16, 8, seed=77)
    with db.write() as wtxn:
        for j in range(16):
            w.add_item(wtxn, 64 + j, extra[j])
        for item in (0, 5, 10, 15, 20, 25, 30, 35):
            w.del_item(wtxn, item)
        w.builder(seed=65).n_trees(2).build(wtxn)
    return dump_index(Reader.open(db.read(), 0, db))


def _one_build(n, device, configure):
    db = Database(None, device=device)
    w = Writer(db, 0, 8)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(n, dtype=np.uint32), random_vectors(n, 8, seed=31))
        configure(w.builder(seed=64).n_trees(2)).build(wtxn)
    return db, w


def budget_golden(device="cpu") -> str:
    """96 items within 32 items' worth of memory: the streaming build."""
    db, _ = _one_build(96, device, lambda b: b.available_memory(32 * 8 * 4))
    return dump_index(Reader.open(db.read(), 0, db))


def mesh_golden(device="cpu", shards=8) -> str:
    """96 items, split_after 8, grown over a mesh (any shard count gives
    the same forest)."""
    mesh = make_mesh(shards, device=device)
    db, _ = _one_build(96, device, lambda b: b.split_after(8).mesh(mesh))
    return dump_index(Reader.open(db.read(), 0, db))


def multi_index_golden(device="cpu") -> str:
    """Two indexes in one database, euclidean 8-d and cosine 4-d."""
    x = random_vectors(64, 8, seed=31)
    y = random_vectors(48, 4, seed=32)
    db = Database(None, device=device)
    w0 = Writer(db, 0, 8)
    w1 = Writer(db, 1, 4, metric="cosine")
    with db.write() as wtxn:
        w0.add_items(wtxn, np.arange(64, dtype=np.uint32), x)
        w1.add_items(wtxn, np.arange(48, dtype=np.uint32), y)
        w0.builder(seed=64).n_trees(2).build(wtxn)
        w1.builder(seed=65).n_trees(2).build(wtxn)
    rtxn = db.read()
    return "\n---\n".join(
        dump_index(Reader.open(rtxn, i, db, metric=m)) for i, m in ((0, "euclidean"), (1, "cosine"))
    )


def delete_collapse_golden(device="cpu") -> str:
    """128 items, then 3 of every 4 deleted and rebuilt."""
    db, w = _one_build(128, device, lambda b: b)
    with db.write() as wtxn:
        for item in range(128):
            if item % 4:
                w.del_item(wtxn, item)
        w.builder(seed=64).n_trees(2).build(wtxn)
    return dump_index(Reader.open(db.read(), 0, db))


def scenarios() -> dict:
    """Snapshot file name → builder taking the device: the twelve files."""
    out = {f"golden_{slug(m)}.txt": (lambda dev, m=m: metric_golden(m, dev)) for m in METRICS}
    out["golden_incremental.txt"] = incremental_golden
    out["golden_budget.txt"] = budget_golden
    out["golden_mesh.txt"] = mesh_golden
    out["golden_multi_index.txt"] = multi_index_golden
    out["golden_delete_collapse.txt"] = delete_collapse_golden
    return out


def snapshot(name: str) -> str:
    with open(os.path.join(SNAP_DIR, name)) as fh:
        return fh.read()
