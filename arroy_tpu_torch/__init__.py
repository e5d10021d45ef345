"""arroy-tpu, ported to PyTorch and CUDA.

A random-projection-forest ANN engine with the public surface of the
JAX package `arroy_tpu` (the reference this package is held against):
the seven distance metrics, the level-synchronous two-means forest
build, the exact serving engine with its two hand-written CUDA kernels
(the fused score + block select, and the binary-quantized popcount
matrix), multi-index databases with MVCC snapshots and the same on-disk
format.  It imports `torch` and never `jax`.

`Database(path=None, device="cuda")` is the one place a device is
chosen; `Writer`, `Reader` and the device index take it from there::

    import numpy as np
    from arroy_tpu_torch import Database, Reader, Writer

    db = Database(device="cuda")           # Database(path, ...) persists
    w = Writer(db, index=0, dimensions=5, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(100), np.random.rand(100, 5))
        w.builder(seed=42).n_trees(10).build(wtxn)

    r = Reader.open(db.read(), 0, db, metric="euclidean")
    print(r.searcher(10)(np.random.rand(3, 5)))
"""

from . import distances
from .errors import (
    ArroyError,
    BuildCancelled,
    DatabaseFull,
    InvalidItemAppend,
    InvalidVecDimension,
    MissingKey,
    MissingMetadata,
    NeedBuild,
    UnknownVersion,
    UnmatchingDistance,
)
from .metrics import Metric, metric_by_name
from .progress import MainStep, SubStep, WriterProgress
from .reader import QueryBuilder, Reader, Searcher, Stats, TreeStats
from .store.database import Database
from .utils.itemset import ItemSet
from .version import CURRENT_VERSION, Version
from .writer import ArroyBuilder, Writer

__version__ = "0.1.0"

__all__ = [
    "ArroyBuilder",
    "ArroyError",
    "BuildCancelled",
    "CURRENT_VERSION",
    "Database",
    "DatabaseFull",
    "InvalidItemAppend",
    "InvalidVecDimension",
    "ItemSet",
    "MainStep",
    "Metric",
    "MissingKey",
    "MissingMetadata",
    "NeedBuild",
    "QueryBuilder",
    "Reader",
    "Searcher",
    "Stats",
    "SubStep",
    "TreeStats",
    "UnknownVersion",
    "UnmatchingDistance",
    "Version",
    "Writer",
    "WriterProgress",
    "distances",
    "metric_by_name",
]
