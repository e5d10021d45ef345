"""Entry point: the batched forest search step on a tiny index.

Counterpart of the JAX package's ``__graft_entry__.entry()``: it builds
the same tiny index (256 x 32 euclidean, 4 trees, seed 7) on the chosen
device and returns ``(fn, example_args)``, where
``fn(qv, qn, qe, qf) -> (ids, dists)`` is one best-first traversal at
search_k 64 (`TraversalFn.traverse`, its leaf logs expanded to candidate
slots) followed by the exact re-score of the top 16, on the database's
device.  `dryrun_multichip` runs the sharded build and search paths on
a mesh (`parallel/`), as ``__graft_entry__.dryrun_multichip`` does.
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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded build and search paths on a mesh of ``n_devices``
    shards (`parallel.mesh.make_mesh`; on one card the shards share it),
    the counterpart of ``__graft_entry__.dryrun_multichip``.

    Five checks, each against a host oracle: a 98,304 x 128 sharded exact
    search (recall@10 >= 0.99), binary-quantized self-retrieval, a
    filtered (candidate-masked) sharded search, the sharded forest's
    traversal and probe fan-out, and a forest built on the mesh, then
    updated on it (512 added, 256 deleted).  Raises on the first failure
    and logs each check's time to standard error."""
    import sys
    import time

    from .parallel.forest import ShardedForestIndex
    from .parallel.mesh import ShardedExactIndex, make_mesh
    from .reader import Reader

    t0 = time.perf_counter()

    def log(msg):
        print(f"[dryrun +{time.perf_counter() - t0:5.1f}s] {msg}", file=sys.stderr, flush=True)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"dryrun_multichip: {what}")

    def hits(got, want):
        return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got, want))

    mesh = make_mesh(n_devices, device=device)
    check(mesh.devices.size == n_devices, f"mesh of {mesh.devices.size} shards")

    # 1. sharded exact search: per-shard top-k and one merge, against a
    #    float64 oracle
    m, d, b, k = 98_304, 128, 16, 10
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, d)).astype(np.float32)
    q = x[rng.integers(0, m, b)] + 0.01 * rng.standard_normal((b, d)).astype(np.float32)
    idx = ShardedExactIndex(mesh, x, metric="euclidean")
    ids, _ = idx.search(q, k)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T + (x64 * x64).sum(1)[None, :]
    want = np.argsort(d2, axis=1)[:, :k]
    check(ids.shape == (b, k) and hits(ids, want) >= 0.99 * b * k, "sharded exact recall")
    log(f"sharded exact {m}x{d}: recall {hits(ids, want) / (b * k):.3f}")

    # 2. binary-quantized: every row retrieves itself at rank 0
    bq_ids, _ = ShardedExactIndex(mesh, x, metric="binary quantized cosine").search(x[:b], 1)
    self_hits = sum(int(bq_ids[i][0]) == i for i in range(b))
    check(self_hits >= b - 1, f"BQ self-retrieval {self_hits}/{b}")
    log(f"sharded BQ self-retrieval: {self_hits}/{b}")

    # 3. filtered: the candidate mask holds, and the oracle agrees
    cand = np.arange(0, m, 3, dtype=np.uint32)
    fids, _ = idx.search(q, k, candidates=cand)
    check(bool(np.isin(fids, cand).all()), "a filtered id outside the candidates")
    wantf = np.argsort(np.where(np.isin(np.arange(m), cand)[None, :], d2, np.inf), axis=1)[:, :k]
    check(hits(fids, wantf) >= 0.99 * b * k, "filtered recall")
    log(f"sharded filtered: recall {hits(fids, wantf) / (b * k):.3f}")

    # 4. the sharded forest: per-shard sub-forests, traversal and probe
    #    fan-out at an exhaustive budget
    mf, df = 16_384, 32
    xf = rng.standard_normal((mf, df)).astype(np.float32)
    fidx = ShardedForestIndex.build(mesh, xf, n_trees=2, split_after=32, seed=3)
    fids2, _ = fidx.search(xf[:b], k, search_k=10**6)
    check(fids2.shape == (b, k) and fids2[0][0] == 0, "forest fan-out self-match")
    log("sharded forest fan-out ok")
    pids, _ = fidx.probe_search(xf[:b], k, search_k=10**6, block=8)
    check(pids.shape == (b, k) and pids[0][0] == 0, "probe fan-out self-match")
    log("sharded probe fan-out ok")

    # 5. one forest built on the mesh, then updated on it
    mb = 16_384
    xb = rng.standard_normal((mb, df)).astype(np.float32)
    db = Database(device=mesh.devices[0])
    w = Writer(db, 0, df, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(mb, dtype=np.uint32), xb)
        w.builder(seed=5).n_trees(2).mesh(mesh).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    check(r.searcher(k, search_k=10**6)(xb[:b])[0][0][0] == 0, "mesh build self-match")
    log("mesh single-forest build ok")
    extra = rng.standard_normal((512, df)).astype(np.float32)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(mb, mb + 512, dtype=np.uint32), extra)
        w.del_items(wtxn, np.arange(0, 256, dtype=np.uint32))
        w.builder(seed=6).n_trees(2).mesh(mesh).build(wtxn)
    r2 = Reader.open(db.read(), 0, db)
    r2.assert_validity()
    check(r2.n_items() == mb + 512 - 256, "item count after the update")
    got2 = r2.searcher(1, search_k=10**6)(extra[:b])
    ins_hits = sum(int(got2[i][0][0]) == mb + i for i in range(b))
    check(ins_hits >= b - 1, f"inserted items found {ins_hits}/{b}")
    check(int(r2.searcher(1, search_k=10**6)(xb[:1])[0][0][0]) != 0, "a deleted item found")
    log("incremental on mesh-built forest ok")
