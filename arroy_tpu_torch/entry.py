"""Entry point: the batched forest search step on a tiny index.

Counterpart of the JAX package's ``__graft_entry__.entry()``: it builds
the same tiny index (256 x 32 euclidean, 4 trees, seed 7) on the chosen
device and returns ``(fn, example_args)``, where
``fn(qv, qn, qe, qf) -> (ids, dists)`` is one best-first traversal at
search_k 64 (`TraversalFn.traverse`, its leaf logs expanded to candidate
slots) followed by the exact re-score of the top 16, on the database's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .search import TraversalFn
from .store.database import Database
from .writer import Writer


def _build_tiny_index(m=256, d=32, n_trees=4, seed=7, device="cuda"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    db = Database(device=device)
    w = Writer(db, 0, d, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        w.builder(seed=seed).n_trees(n_trees).build(wtxn)
    return db.device_index(0, db.read().state(0)), x


def entry(device="cuda"):
    """Return ``(fn, example_args)``: traverse + re-score of a batch of 8
    queries (the index's first 8 items), tensors on ``device``."""
    dev, x = _build_tiny_index(device=device)
    tf = TraversalFn(dev, 16, 64, None, "exact")

    def fn(qv, qn, qe, qf):
        log, _, _ = tf.traverse(tf.margins(qv, qf), tf.pmax, tf.q_cap)
        return tf.rescore(tf.expand(log), qv, qn, qe)

    b = 8
    qv = torch.from_numpy(x[:b]).to(dev.device)
    zeros = torch.zeros(b, dtype=torch.float32, device=dev.device)
    return fn, (qv, zeros, zeros.clone(), torch.ones(b, dtype=torch.float32, device=dev.device))
