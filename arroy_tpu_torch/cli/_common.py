"""Shared CLI plumbing: vector file IO and argument helpers.

Vector input format (the stdin format of the reference's import tool,
reference: examples/import-vectors.rs): one vector per line,
``<id>,v0,v1,...`` or whitespace-separated floats (ids auto-assigned).
``.npy`` files (``[m, d]`` float32) are also accepted.
"""

from __future__ import annotations

import sys

import numpy as np


def read_vectors(path: str | None, dims: int | None = None):
    """Returns (ids, vectors) from a file path, .npy, or stdin ('-')."""
    if path and path.endswith(".npy"):
        x = np.load(path).astype(np.float32)
        return np.arange(len(x), dtype=np.uint32), x
    fh = sys.stdin if path in (None, "-") else open(path)
    ids, rows = [], []
    auto = 0
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if "," in line:
            parts = line.split(",")
            ids.append(int(parts[0]))
            rows.append([float(p) for p in parts[1:]])
        else:
            ids.append(auto)
            auto += 1
            rows.append([float(p) for p in line.split()])
    if fh is not sys.stdin:
        fh.close()
    if not rows:
        raise SystemExit("no vectors in input")
    x = np.asarray(rows, dtype=np.float32)
    if dims is not None and x.shape[1] != dims:
        raise SystemExit(f"expected {dims} dims, got {x.shape[1]}")
    return np.asarray(ids, dtype=np.uint32), x


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda", help="torch device of the database (cuda, cpu)")


def add_db_args(ap):
    ap.add_argument("--db", required=True, help="database directory")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--distance", default="euclidean")
    add_device_arg(ap)
