"""On-disk index container with atomic generation publishing.

The reference's durability unit is the LMDB transaction: a crashed or
aborted build leaves the database at the previous commit (reference:
src/lib.rs:1-3).  Our equivalent is generation directories: a commit
writes a complete new generation for each dirty index, then atomically
renames a new MANIFEST into place.  Readers and other processes always
open the manifest's generations, so they see either the old or the new
commit, never a torn state.

Layout::

    <root>/MANIFEST.json
    <root>/idx_00000/gen_00000042/{meta.json, *.npy}

Arrays are plain .npy so other tools (and mmap) can read them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

from ..errors import UnknownVersion
from ..metrics import metric_by_name
from ..models.forest import Forest
from ..models.items import ItemStore
from ..utils.itemset import ItemSet
from ..version import CURRENT_VERSION, V1_0_0, Version

FORMAT_NAME = "arroy-tpu"


def _index_dir(root: str, index: int) -> str:
    return os.path.join(root, f"idx_{index:05d}")


def save(root: str, states) -> None:
    os.makedirs(root, exist_ok=True)
    manifest_path = os.path.join(root, "MANIFEST.json")
    old = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f).get("indexes", {})

    indexes: dict[str, dict] = {}
    for index, st in states.items():
        gen = st.generation
        key = str(index)
        gen_dir = os.path.join(_index_dir(root, index), f"gen_{gen:08d}")
        if old.get(key, {}).get("gen") == gen and os.path.isdir(gen_dir):
            indexes[key] = {"gen": gen}
            continue
        _write_state(gen_dir, st)
        indexes[key] = {"gen": gen}

    manifest = {
        "format": FORMAT_NAME,
        "version": str(CURRENT_VERSION),
        "indexes": indexes,
    }
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".manifest.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path)
    _fsync_dir(root)
    _gc(root, indexes)


def _write_state(gen_dir: str, st) -> None:
    if os.path.isdir(gen_dir):
        shutil.rmtree(gen_dir)
    tmp_dir = gen_dir + ".tmp"
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)

    use_container = os.environ.get("ARROY_TPU_NPY_STORE", "0") != "1"

    # the npy layout IS the v1.0.0 format: stamp the generation
    # store-accurately so a later open sees an upgradable v1.0.0 index
    # (ARROY_TPU_NPY_STORE=1 means "write the legacy layout")
    stamped = st.version if use_container else min(st.version, V1_0_0)
    meta = {
        "dims": st.dims,
        "metric": st.metric.name,
        "version": str(stamped),
        "generation": st.generation,
        "updated": sorted(int(i) for i in st.updated),
        "roots": [int(r) for r in st.forest.roots],
        "has_metadata": st.metadata is not None,
    }
    if st.metadata is not None:
        meta["metadata"] = {
            "dimensions": st.metadata.dimensions,
            "distance": st.metadata.distance,
            "roots": [int(r) for r in st.metadata.roots],
        }

    f_ = st.forest
    sd = st.metric.storage_dim(st.dims)
    np_dtype = np.uint32 if st.metric.binary else np.float32
    leaf_nodes = np.asarray(sorted(f_.leaves), dtype=np.int64)
    offs = np.zeros(len(leaf_nodes) + 1, np.int64)
    chunks = []
    for i, nid in enumerate(leaf_nodes):
        chunks.append(f_.leaves[int(nid)])
        offs[i + 1] = offs[i] + len(chunks[-1])
    flat = np.concatenate(chunks) if chunks else np.empty(0, np.uint32)

    arrays = {
        "item_rows": st.store.rows(),
        "item_norms": st.store.norms(),
        "item_extras": st.store.extras(),
        "slot_ids": st.store.slot_ids(),
        "forest_kind": f_.kind,
        "forest_left": f_.left,
        "forest_right": f_.right,
        "forest_ptr": f_.ptr,
        "normals": f_.normals if f_.normals is not None else np.zeros((0, sd), np_dtype),
        "aux": f_.aux,
        "leaf_nodes": leaf_nodes,
        "leaf_offs": offs,
        "leaf_items": flat,
    }
    if st.metadata is not None:
        arrays["metadata_items"] = st.metadata.items.ids

    if use_container:
        from .. import native

        meta["store"] = "container"
        native.write_container(os.path.join(tmp_dir, "state.atc"), arrays)
    else:
        meta["store"] = "npy"
        for name, arr in arrays.items():
            np.save(os.path.join(tmp_dir, f"{name}.npy"), arr)

    with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())

    # durability: every generation file must reach disk before the
    # manifest can point at it — fsync any file the writers above did not
    # (npy path), then the directory entries themselves
    if not use_container:
        for name in os.listdir(tmp_dir):
            fd = os.open(os.path.join(tmp_dir, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    _fsync_dir(tmp_dir)
    os.replace(tmp_dir, gen_dir)
    _fsync_dir(os.path.dirname(gen_dir))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load(root: str) -> dict[int, "IndexState"]:
    """Load the manifest's generations, retrying if a concurrent commit
    garbage-collects the generation we were reading mid-load (readers
    must see either the old or the new commit, never a crash)."""
    last: Exception | None = None
    for _ in range(5):
        try:
            return _load_once(root)
        except (FileNotFoundError, OSError) as e:
            last = e
    raise last


def _load_once(root: str) -> dict[int, "IndexState"]:
    from .database import IndexState, Metadata

    manifest_path = os.path.join(root, "MANIFEST.json")
    if not os.path.exists(manifest_path):
        return {}
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_NAME:
        raise UnknownVersion(str(manifest.get("format")))
    ver = Version.parse(manifest["version"])
    if ver.major != CURRENT_VERSION.major:
        raise UnknownVersion(str(ver))

    out: dict[int, IndexState] = {}
    for key, info in manifest.get("indexes", {}).items():
        index = int(key)
        gen_dir = os.path.join(_index_dir(root, index), f"gen_{info['gen']:08d}")
        with open(os.path.join(gen_dir, "meta.json")) as f:
            meta = json.load(f)
        metric = metric_by_name(meta["metric"])
        dims = int(meta["dims"])

        container = None
        if meta.get("store", "npy") == "container":
            from .. import native

            container = native.Container(os.path.join(gen_dir, "state.atc"))

            def arr(name):
                # mutable copy: IndexState arrays are written in place by
                # later builds; the mmap view itself is read-only
                return np.array(container.array(name))

        else:

            def arr(name):
                return np.load(os.path.join(gen_dir, f"{name}.npy"))

        store = ItemStore.from_arrays(
            metric,
            dims,
            arr("item_rows"),
            arr("item_norms"),
            arr("item_extras"),
            arr("slot_ids"),
        )

        forest = Forest(
            kind=arr("forest_kind"),
            left=arr("forest_left"),
            right=arr("forest_right"),
            ptr=arr("forest_ptr"),
            normals=arr("normals"),
            aux=arr("aux"),
            roots=[int(r) for r in meta["roots"]],
        )
        leaf_nodes = arr("leaf_nodes")
        offs = arr("leaf_offs")
        flat = arr("leaf_items")
        for i, nid in enumerate(leaf_nodes):
            forest.leaves[int(nid)] = flat[offs[i] : offs[i + 1]]

        metadata = None
        if meta.get("has_metadata"):
            md = meta["metadata"]
            metadata = Metadata(
                dimensions=int(md["dimensions"]),
                items=ItemSet.from_sorted(arr("metadata_items")),
                roots=[int(r) for r in md["roots"]],
                distance=md["distance"],
            )

        out[index] = IndexState(
            dims=dims,
            metric=metric,
            store=store,
            updated=set(meta.get("updated", [])),
            forest=forest,
            metadata=metadata,
            version=Version.parse(meta["version"]),
            generation=int(meta["generation"]),
        )
        if container is not None:
            container.close(force=True)  # every array was copied above
    return out


def _gc(root: str, indexes: dict[str, dict]) -> None:
    """Best-effort removal of superseded generation directories (and of
    dropped indexes' directories).  Readers racing this are covered by
    `load`'s retry loop."""
    for key, info in indexes.items():
        idir = _index_dir(root, int(key))
        if not os.path.isdir(idir):
            continue
        keep = f"gen_{info['gen']:08d}"
        for name in os.listdir(idir):
            if name != keep:
                shutil.rmtree(os.path.join(idir, name), ignore_errors=True)
    live = {_index_dir(root, int(k)) for k in indexes}
    for name in os.listdir(root):
        p = os.path.join(root, name)
        if name.startswith("idx_") and os.path.isdir(p) and p not in live:
            shutil.rmtree(p, ignore_errors=True)
