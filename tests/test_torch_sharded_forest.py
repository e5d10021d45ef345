"""The port's corpus-sharded forest index (`arroy_tpu_torch.parallel.forest`).

First `tests/test_sharded_forest.py`'s six tests on an 8-shard CPU mesh.
Then parity on identical state: 8 sub-forests built by the JAX package
(round-robin items, seed 3 + s, as `ShardedForestIndex.build` builds
them) and written to disk; the JAX package's index takes its per-shard
packs and states, the port's takes the same packs and the states it
opens from those directories.

Tolerances: ids equal tie-aware, distances rtol 1e-5 with a 1e-6
absolute floor.  The traversal's margins come from each package's own
f32 matmul and may differ in the last bit (see `test_torch_traverse.py`);
a query whose result differs is run again on the JAX package's margins,
where it must be equal.  The probe is held at the JAX package's re-score
cut (`probe.JAX_CUT`), and at its own cut it must find at least as many
true neighbours.
"""

import jax
import numpy as np
import pytest

import arroy_tpu
import arroy_tpu_torch
from arroy_tpu.device import DeviceIndex as JDeviceIndex
from arroy_tpu.parallel.forest import ShardedForestIndex as JShardedForestIndex
from arroy_tpu.parallel.mesh import make_mesh as j_make_mesh
from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch import probe as t_probe
from arroy_tpu_torch.parallel.forest import ShardedForestIndex
from arroy_tpu_torch.parallel.mesh import make_mesh

from .torch_util import recall, tie_aware_equal
from .util import random_vectors

N_SHARDS, M, DIM, K = 8, 2400, 16, 10


def _mesh():
    return make_mesh(N_SHARDS, device="cpu")


def _exact_ids(x, q, k):
    d = np.sum((x[None, :, :] - q[:, None, :]) ** 2, axis=-1)
    return np.argsort(d, axis=1)[:, :k]


def test_sharded_forest_exhaustive_matches_exact():
    x = random_vectors(400, 16, seed=1)
    idx = ShardedForestIndex.build(_mesh(), x, n_trees=3, seed=5)
    q = x[:6]
    ids, dists = idx.search(q, 10, search_k=10**7)
    want = _exact_ids(x, q, 10)
    for b in range(len(q)):
        assert set(ids[b]) == set(want[b]), (ids[b], want[b])
        assert ids[b][0] == b  # self-match first
    # distances are normalized (sqrt of squared L2)
    np.testing.assert_allclose(dists[0][1], np.linalg.norm(x[ids[0][1]] - x[0]), rtol=1e-4)


def test_sharded_forest_recall_default_search_k():
    x = random_vectors(800, 16, seed=2)
    idx = ShardedForestIndex.build(_mesh(), x, n_trees=4, seed=7)
    q = x[:32]
    ids, _ = idx.search(q, 10, search_k=4 * 10 * 20 * 8)
    assert recall(ids, _exact_ids(x, q, 10)) > 0.85


def test_sharded_forest_uneven_items():
    # 401 items over 8 shards: unequal shard sizes and the padding paths
    x = random_vectors(401, 8, seed=3)
    idx = ShardedForestIndex.build(_mesh(), x, n_trees=2, seed=9)
    ids, _ = idx.search(x[:3], 5, search_k=10**7)
    want = _exact_ids(x, x[:3], 5)
    for b in range(3):
        assert set(ids[b]) == set(want[b])


def test_parallel_build_equals_sequential_build():
    """One thread a shard builds the same sub-forests (each shard's grow
    draws from its own generator, seeded with seed + s)."""
    x = random_vectors(600, 8, seed=6)
    a = ShardedForestIndex.build(make_mesh(4, device="cpu"), x, n_trees=2, seed=3)
    b = ShardedForestIndex.build(make_mesh(4, device="cpu"), x, n_trees=2, seed=3,
                                 parallel_build=True)
    for sa, sb in zip(a._states, b._states):
        assert sa.forest.roots == sb.forest.roots and set(sa.forest.leaves) == set(sb.forest.leaves)
        np.testing.assert_array_equal(sa.forest.normals, sb.forest.normals)
    np.testing.assert_array_equal(a.search(x[:8], 5, search_k=100)[0],
                                  b.search(x[:8], 5, search_k=100)[0])


def test_sharded_forest_cosine():
    x = random_vectors(256, 8, seed=4)
    idx = ShardedForestIndex.build(_mesh(), x, metric="cosine", n_trees=2, seed=11)
    ids, dists = idx.search(x[:4], 5, search_k=10**7)
    assert ids[0][0] == 0
    assert abs(dists[0][0]) < 1e-5


def test_sharded_probe_matches_single_device_probe():
    """Recall parity with the single-device probe at the same total
    candidate budget; an exhaustive budget is exact."""
    m, d, k = 2048, 16, 10
    x = random_vectors(m, d, seed=13)
    idx = ShardedForestIndex.build(_mesh(), x, n_trees=3, seed=13, split_after=32)
    q = x[:16]
    want = _exact_ids(x, q, k)
    ids, dists = idx.probe_search(q, k, search_k=10**7, block=8)
    for b in range(len(q)):
        assert set(ids[b]) == set(want[b]), (ids[b], want[b])
        assert ids[b][0] == b
    np.testing.assert_allclose(dists[0][1], np.linalg.norm(x[ids[0][1]] - x[0]), rtol=1e-4)

    db = Database(device="cpu")
    w = Writer(db, 0, d, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        w.builder(seed=13).n_trees(3).split_after(32).build(wtxn)
    r = Reader.open(db.read(), 0, db)
    sk = 3 * k * 20 * 8
    s = r.searcher(k, search_k=sk, engine="forest", traversal="probe", probe_block=8,
                   probe_dtype="f32")
    single = recall(np.array([[i for i, _ in row] for row in s(q)]), want)
    ids2, _ = idx.probe_search(q, k, search_k=sk, block=8, dtype="f32")
    sharded = recall(ids2, want)
    # parity within a few points (different tree seeds across shards)
    assert sharded >= single - 0.1 and sharded >= 0.8


def test_sharded_probe_bq_tables_and_uneven():
    # packed sign-bit shard tables and an item count 8 does not divide
    x = random_vectors(777, 8, seed=14)
    idx = ShardedForestIndex.build(_mesh(), x, n_trees=2, seed=14, split_after=16)
    ids, _ = idx.probe_search(x[:4], 5, search_k=10**7, block=4, dtype="bq")
    want = _exact_ids(x, x[:4], 5)
    for b in range(4):
        assert set(ids[b]) == set(want[b])


# ---------------------------------------------------------------------------
# parity on identical state
# ---------------------------------------------------------------------------


def _corpus(seed=21):
    """Clustered rows (16 parents), and queries that are noisier draws."""
    rng = np.random.default_rng(seed)
    parents = rng.standard_normal((16, DIM)).astype(np.float32)
    n = M + 32
    pa, pb = rng.integers(16, size=n), rng.integers(16, size=n)
    x = np.where(rng.random((n, DIM)) < 0.5, parents[pa], parents[pb]).astype(np.float32)
    x[:M] += 0.05 * rng.standard_normal((M, DIM)).astype(np.float32)
    x[M:] += 0.5 * rng.standard_normal((32, DIM)).astype(np.float32)
    return x[:M], x[M:]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """metric -> (JAX index, port index, corpus, queries) on identical state."""
    x, q = _corpus()
    built = {}

    def get(metric):
        if metric in built:
            return built[metric]
        packs, jstates, tstates = [], [], []
        for s in range(N_SHARDS):
            path = str(tmp_path_factory.mktemp(f"{metric.replace(' ', '_')}_{s}"))
            sel = np.arange(s, M, N_SHARDS)
            db = arroy_tpu.Database(path)
            w = arroy_tpu.Writer(db, 0, DIM, metric=metric)
            with db.write() as wtxn:
                w.add_items(wtxn, sel.astype(np.uint32), x[sel])
                w.builder(seed=3 + s).n_trees(4).split_after(24).build(wtxn)
            st = db.read().state(0)
            jstates.append(st)
            packs.append(JDeviceIndex.build_np(st.metric, DIM, st.store, st.forest))
            tstates.append(arroy_tpu_torch.Database(path, device="cpu").read().state(0))
        jidx = JShardedForestIndex(j_make_mesh(N_SHARDS), packs, jstates[0].metric, DIM,
                                   states=jstates)
        tidx = ShardedForestIndex(_mesh(), packs, metric, DIM, states=tstates)
        built[metric] = (jidx, tidx, x, q)
        return built[metric]

    return get


def _jax_margins(jidx, s, q):
    metric = jidx.metric
    qv = metric.encode_np(q)
    qf = np.zeros(len(q), np.float32) if metric.has_extra else np.ones(len(q), np.float32)
    normals, aux = np.asarray(jidx.normals)[s], np.asarray(jidx.aux)[s]
    return np.asarray(jax.jit(metric.margin_matrix)(normals, aux, qv, qf))


def _row_equal(ja, jd, ta, td):
    try:
        np.testing.assert_array_equal(np.isnan(jd), np.isnan(td))
        tie_aware_equal(ta[None], np.nan_to_num(td)[None], ja[None], np.nan_to_num(jd)[None],
                        rtol=1e-5, atol=1e-6)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot-product",
                                    "binary quantized cosine"])
def test_sharded_search_matches_jax(pair, metric):
    """The fan-out traversal at a budget that cuts and at an exhaustive
    one; a differing row must agree on the JAX package's margins."""
    import torch

    jidx, tidx, _, q = pair(metric)
    for sk in (200, 10**7):
        jids, jd = jidx.search(q, K, search_k=sk)
        tids, td = tidx.search(q, K, search_k=sk)
        bad = [i for i in range(len(q)) if not _row_equal(jids[i], jd[i], tids[i], td[i])]
        if not bad:
            continue
        rows = q[bad]
        plan = tidx.plan(K, sk)
        parts = []
        for s in range(N_SHARDS):
            qs = tidx._queries(rows, s)
            jm = torch.from_numpy(_jax_margins(jidx, s, rows))
            parts.append(tidx.shard_search(s, plan, *qs, margins=jm))
        from arroy_tpu_torch.parallel.mesh import merge_topk

        ids, d = merge_topk(tidx.metric, DIM, K, parts, "cpu")
        for j, i in enumerate(bad):
            assert _row_equal(jids[i], jd[i], ids[j].numpy(), d[j].numpy()), f"query {i}"


@pytest.mark.parametrize("dtype", ["bf16", "f32", "bq"])
def test_sharded_probe_matches_jax(pair, monkeypatch, dtype):
    """At the JAX package's re-score cut the probe fan-out returns its
    results; at the port's own cut (an eighth of search_k past the floor)
    it finds at least as many true neighbours."""
    jidx, tidx, x, q = pair("euclidean")
    sk = 40000  # 5,000 a shard: the port's cut is 1024 or the pool, the JAX package's 512
    kw = dict(search_k=sk, n_trees=4, block=8, dtype=dtype)
    jids, jd = jidx.probe_search(q, K, **kw)
    monkeypatch.setattr(t_probe, "JAX_CUT", True)
    tids, td = tidx.probe_search(q, K, **kw)
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    tie_aware_equal(tids, np.nan_to_num(td), jids.astype(np.int64), np.nan_to_num(jd),
                    rtol=1e-5, atol=1e-6)
    tables = tidx.enable_probe(n_trees=4, block=8, dtype=dtype)
    jax_k2 = tidx.probe_plan(K, sk, tables, dtype)["k2"]
    monkeypatch.setattr(t_probe, "JAX_CUT", False)
    plan = tidx.probe_plan(K, sk, tables, dtype)
    # sign-bit tables were an estimate's cut in both packages already
    assert plan["k2"] > jax_k2 if dtype != "bq" else plan["k2"] == jax_k2
    wide, _ = tidx.probe_search(q, K, **kw)
    exact = _exact_ids(x, q, K)
    assert recall(wide, exact) >= recall(tids, exact)
