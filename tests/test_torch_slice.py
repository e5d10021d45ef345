"""The whole slice through the public API, against the JAX package.

add → build → persist → reopen → `searcher()` → `__call__`, the same
sequence in both packages on one seeded 20,000 x 64 corpus.  Exact
search does not depend on the forest, so the f32x1 results must be equal
(tie-aware, distances rtol 1e-4) even though the forests differ; the
port's default searcher must take the fused select and keep recall@10
>= 0.99 against them.  The port's forest traversal (`nns()` and
`searcher(engine="forest")`) must return sorted results whose distances
are the exact ones of their ids.  Also: the port imports no JAX, at any
depth.
"""

import os
import subprocess
import sys

import numpy as np

import arroy_tpu
import arroy_tpu_torch

from .torch_util import recall, tie_aware_equal

M, DIM, K = 20_000, 64, 10


def _slice(pkg, path, x, **db_kw):
    db = pkg.Database(str(path), **db_kw)
    w = pkg.Writer(db, 0, DIM, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(M, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(2).build(wtxn)
    db = pkg.Database(str(path), **db_kw)  # reopen from disk
    r = pkg.Reader.open(db.read(), 0, db, metric="euclidean")
    r.assert_validity()
    return r


def _arrays(results):
    ids = np.array([[i for i, _ in row] for row in results])
    d = np.array([[v for _, v in row] for row in results])
    return ids, d


def test_slice_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, DIM)).astype(np.float32)
    q = x[rng.integers(M, size=32)] + 0.1 * rng.standard_normal((32, DIM)).astype(np.float32)
    jr = _slice(arroy_tpu, tmp_path / "jax", x)
    tr = _slice(arroy_tpu_torch, tmp_path / "torch", x, device="cpu")
    assert (tr.n_items(), tr.n_trees(), tr.dimensions()) == (M, 2, DIM)

    jids, jd = _arrays(jr.searcher(K, engine="exact", precision="f32x1")(q))
    s = tr.searcher(K, engine="exact", precision="f32x1")
    assert s.route == "f32x1"
    tids, td = _arrays(s(q))
    tie_aware_equal(tids, td, jids, jd, rtol=1e-4, atol=1e-6)

    s = tr.searcher(K)  # engine="auto", precision="auto": exact, bf16
    assert s.engine == "exact" and s.route == "fused_select"
    assert recall(_arrays(s(q))[0], jids) >= 0.99
    # the best-first traversal: nns() and searcher(engine="forest") under
    # 262,144 items walk the same forest with the same budget; each result
    # is sorted, and its distances are the exact ones of its ids
    got = tr.nns(K).search_k(2000).by_vector(q[0])
    assert len(got) == K
    ids = np.array([i for i, _ in got])
    d = np.array([v for _, v in got])
    assert np.all(np.diff(d) >= 0)
    np.testing.assert_allclose(d, np.sqrt(((x[ids] - q[0]) ** 2).sum(1)), rtol=1e-5)
    s = tr.searcher(K, search_k=2000, engine="forest", rescore="exact")
    assert s.route == "traversal"
    assert s(q) == tr.nns(K).search_k(2000).by_vectors(q)
    assert s(q[:1])[0] == got


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import arroy_tpu_torch\n"
        "for m in pkgutil.walk_packages(arroy_tpu_torch.__path__, 'arroy_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'arroy_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'arroy_tpu' not in sys.modules\n"
        "walked = {'arroy_tpu_torch.parallel.' + n for n in ('mesh', 'forest', 'build')}\n"
        "assert walked <= set(sys.modules), walked - set(sys.modules)\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=root
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
