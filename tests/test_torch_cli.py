"""The port's 11 CLI tools (`arroy_tpu_torch.cli`) against the JAX
package's, run in-process through each tool's ``main(argv)`` with
``--device cpu``; stdout is captured and parsed.

- `sample_vectors` writes the JAX tool's ``.npy`` byte for byte (and the
  same text lines);
- on one index written by the JAX tools, `stats`, `check` and `graph`
  print exactly what the JAX tools print;
- `upgrade` prints what the JAX tool prints and leaves the same state;
- `import_vectors` and `build_only` give an index whose items equal the
  input and that passes `assert_validity`;
- `search_bench`, `compare_exact`, `recall_sweep` and `fuzz` complete at a
  small size and print parseable numbers; `recall_sweep --exact-point`
  prints recall@10 >= 0.99.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import arroy_tpu
from arroy_tpu.cli import check as j_check
from arroy_tpu.cli import graph as j_graph
from arroy_tpu.cli import import_vectors as j_import
from arroy_tpu.cli import sample_vectors as j_sample
from arroy_tpu.cli import stats as j_stats
from arroy_tpu.cli import upgrade as j_upgrade_cli
from arroy_tpu_torch import Database, Reader
from arroy_tpu_torch.cli import (
    build_only,
    check,
    compare_exact,
    fuzz,
    graph,
    import_vectors,
    recall_sweep,
    sample_vectors,
    search_bench,
    stats,
    upgrade,
)

CPU = ["--device", "cpu"]
NUM = r"([0-9]+(?:\.[0-9]+)?)"
ASSET_V1_1 = os.path.join(os.path.dirname(__file__), "assets", "v1_1_zero_normal")


def _run(capsys, tool, argv):
    capsys.readouterr()
    tool.main(argv)
    return capsys.readouterr().out


def test_sample_vectors_matches_jax(tmp_path, capsys):
    args = ["--count", "300", "--dimensions", "24", "--parents", "8", "--seed", "5"]
    j_sample.main(args + ["-o", str(tmp_path / "j.npy")])
    sample_vectors.main(args + ["-o", str(tmp_path / "t.npy")] + CPU)
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    small = ["--count", "5", "--dimensions", "3"]
    assert _run(capsys, sample_vectors, small + CPU) == _run(capsys, j_sample, small)


@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    """A database written by the JAX tools: index 0 euclidean (8 trees) and
    index 1 binary quantized cosine, from `sample_vectors` output."""
    root = tmp_path_factory.mktemp("cli")
    vecs = str(root / "v.npy")
    j_sample.main(["--count", "1500", "--dimensions", "32", "-o", vecs])
    db = str(root / "db")
    j_import.main(["--db", db, "--n-trees", "8", vecs])
    j_import.main(["--db", db, "--index", "1", "--distance", "binary quantized cosine",
                   "--n-trees", "3", vecs])
    return db, vecs


@pytest.mark.parametrize("index,distance", [(0, "euclidean"), (1, "binary quantized cosine")])
def test_stats_and_graph_print_what_jax_prints(capsys, jax_db, index, distance):
    db, _ = jax_db
    args = ["--db", db, "--index", str(index), "--distance", distance]
    want = _run(capsys, j_stats, args)
    assert _run(capsys, stats, args + CPU) == want
    assert re.search(r"device \(HBM\) footprint: " + NUM + " MiB", want)
    want = _run(capsys, j_graph, args)
    got = _run(capsys, graph, args + CPU)
    assert got == want and got.startswith("digraph {") and got.rstrip().endswith("}")


def test_check_prints_what_jax_prints(capsys, jax_db):
    db, _ = jax_db
    want = _run(capsys, j_check, ["--db", db])
    assert _run(capsys, check, ["--db", db] + CPU) == want
    assert "index 1: structure OK - 1500 items, 3 trees, 32 dims" in want
    assert _run(capsys, check, ["--db", db, "--index", "0"] + CPU) == _run(
        capsys, j_check, ["--db", db, "--index", "0"])


def test_upgrade_matches_jax_tool(tmp_path, capsys):
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(ASSET_V1_1, jpath)
    shutil.copytree(ASSET_V1_1, tpath)
    want = _run(capsys, j_upgrade_cli, ["--db", jpath, "--index", "1"])
    assert _run(capsys, upgrade, ["--db", tpath, "--index", "1"] + CPU) == want
    assert want == "index 1: 1.1.0 -> 1.2.0\n"
    want = _run(capsys, j_upgrade_cli, ["--db", jpath])
    assert _run(capsys, upgrade, ["--db", tpath] + CPU) == want == "upgraded indexes [0] -> 1.2.0\n"
    assert _run(capsys, upgrade, ["--db", tpath] + CPU) == "all indexes already at 1.2.0\n"
    jdb, tdb = arroy_tpu.Database(jpath), Database(tpath, device="cpu")
    for idx in (0, 1):
        js, ts = jdb.read().state(idx), tdb.read().state(idx)
        assert str(ts.version) == str(js.version) == "1.2.0"
        for a, b in ((ts.forest.kind, js.forest.kind), (ts.forest.ptr, js.forest.ptr),
                     (ts.forest.normals, js.forest.normals), (ts.forest.aux, js.forest.aux),
                     (ts.store.rows(), js.store.rows())):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _items_equal(db_path, index, ids, x, distance="euclidean"):
    db = Database(db_path, device="cpu")
    r = Reader.open(db.read(), index, db, metric=distance)
    r.assert_validity()
    assert r.n_items() == len(ids)
    for i, v in zip(ids, x):
        np.testing.assert_array_equal(r.item_vector(int(i)), v)
    return r


def test_import_vectors_npy_text_and_append(tmp_path, capsys):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 12)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    db = str(tmp_path / "db")
    out = _run(capsys, import_vectors, ["--db", db, "--n-trees", "3", str(tmp_path / "x.npy")] + CPU)
    assert re.fullmatch(r"inserted 400 x 12-d vectors in " + NUM + r"s\nbuilt in " + NUM
                        + r"s; committed\n", out), out
    r = _items_equal(db, 0, np.arange(400), x)
    assert r.n_trees() == 3
    # the text format with explicit ids (<id>,v0,...), into another index
    ids = np.arange(50) * 7 + 3
    vals = np.round(x[:50], 4)
    with open(tmp_path / "x.txt", "w") as f:
        for i, v in zip(ids, vals):
            f.write(f"{i}," + ",".join(f"{a:.4f}" for a in v) + "\n")
    _run(capsys, import_vectors, ["--db", db, "--index", "1", "--dimensions", "12",
                                  str(tmp_path / "x.txt")] + CPU)
    _items_equal(db, 1, ids, vals)
    # the ordered append path, whitespace-separated rows with auto ids
    with open(tmp_path / "y.txt", "w") as f:
        for v in vals[:20]:
            f.write(" ".join(f"{a:.4f}" for a in v) + "\n")
    _run(capsys, import_vectors, ["--db", db, "--index", "2", "--append", "--split-after", "8",
                                  "--available-memory", "4096", str(tmp_path / "y.txt")] + CPU)
    _items_equal(db, 2, np.arange(20), vals[:20])


def test_build_only_commits_nothing(tmp_path, capsys, jax_db):
    db = str(tmp_path / "db")
    shutil.copytree(jax_db[0], db)
    before = Database(db, device="cpu").read().state(0).generation
    out = _run(capsys, build_only, ["--db", db, "--n-trees", "5", "--seed", "3"] + CPU)
    assert re.fullmatch(r"built in " + NUM + r"s \(NOT committed\)\n", out), out
    st = Database(db, device="cpu").read().state(0)
    assert st.generation == before and len(st.metadata.roots) == 8
    # with vectors: imported and built inside the aborted transaction
    out = _run(capsys, build_only, ["--db", db, "--index", "3", jax_db[1]] + CPU)
    assert "NOT committed" in out
    assert Database(db, device="cpu").read().state(3) is None
    with pytest.raises(SystemExit):
        build_only.main(["--db", db, "--index", "9"] + CPU)


def test_search_bench_both_modes(capsys, jax_db):
    db, _ = jax_db
    out = _run(capsys, search_bench, ["--db", db, "--count", "10", "--batch", "64", "--limit",
                                      "256", "--traversal", "xla"] + CPU)
    m = re.fullmatch(r"256 queries in " + NUM + r"s -> " + NUM + r" qps \(batch=64\)\n", out)
    assert m and float(m.group(2)) > 0, out
    assert "ARROY_TRAVERSAL" not in os.environ or os.environ["ARROY_TRAVERSAL"] != "xla"
    out = _run(capsys, search_bench, ["--db", db, "--count", "5", "--limit", "12",
                                      "--search-k", "200"] + CPU)
    assert re.fullmatch(r"12 queries: avg=" + NUM + r"ms min=" + NUM + r"ms max=" + NUM
                        + r"ms stddev=" + NUM + r"ms\n", out), out


def test_compare_exact_small(capsys):
    out = _run(capsys, compare_exact, ["--m", "600", "--dims", "16", "--n-trees", "4",
                                       "--queries", "32"] + CPU)
    lines = out.splitlines()
    assert re.fullmatch(r"build: " + NUM + "s", lines[0])
    m = re.fullmatch(r"forest: " + NUM + r" qps  recall@5=" + NUM + r" \(search_k=400\)", lines[1])
    assert m and 0.5 <= float(m.group(2)) <= 1.0, out
    assert re.fullmatch(r"exact : " + NUM + r" qps  recall@5=1\.0000", lines[2])


@pytest.mark.parametrize("distance,floor", [("euclidean", 0.99), ("binary quantized cosine", 0.99)])
def test_recall_sweep_exact_point(capsys, distance, floor):
    out = _run(capsys, recall_sweep, ["--m", "1500", "--dims", "24", "--n-trees", "4",
                                      "--queries", "32", "--search-k", "50", "400",
                                      "--distance", distance, "--exact-point"] + CPU)
    rows = re.findall(r"(search_k=\s*\d+|exact\s+)\s+recall@10=" + NUM + r"\s+qps=\s*" + NUM, out)
    assert [r[0].split("=")[-1].strip() for r in rows] == ["50", "400", "exact"], out
    assert all(float(q) > 0 for _, _, q in rows)
    assert float(rows[-1][1]) >= floor
    assert float(rows[0][1]) <= float(rows[1][1]) + 0.05


def test_recall_sweep_probe_and_persisted_reuse(tmp_path, capsys):
    args = ["--m", "1200", "--dims", "16", "--n-trees", "3", "--queries", "16", "--data", "glove",
            "--search-k", "300", "--traversal", "probe", "--probe-trees", "2",
            "--probe-block", "16", "--db", str(tmp_path / "db")] + CPU
    first = _run(capsys, recall_sweep, args)
    assert first.startswith("build: ")
    again = _run(capsys, recall_sweep, args)
    assert again.startswith("reusing persisted index")
    # the same index and queries give the same recall
    assert re.findall(r"recall@10=" + NUM, first) == re.findall(r"recall@10=" + NUM, again)
    # --multipop runs the multi-pop traversal (it raised before the port had one)
    out = _run(capsys, recall_sweep, ["--m", "300", "--dims", "8", "--queries", "4", "--search-k",
                                      "40", "--data", "random", "--multipop", "2"] + CPU)
    assert re.findall(r"search_k=\s+40\s+recall@10=" + NUM, out), out


def test_fuzz_short_run_with_reloads(tmp_path, capsys):
    out = _run(capsys, fuzz, ["--seconds", "2", "--dims", "6", "--indexes", "2", "--drop-prob",
                              "0.3", "--path", str(tmp_path / "db"), "--reload-every", "2",
                              "--ops-per-batch", "20", "--batches-per-commit", "2"] + CPU)
    m = re.search(r"done: (\d+) iterations in " + NUM + r"s \((\d+) reloads, (\d+) index drops\), "
                  r"no invariant violations", out)
    assert m and int(m.group(1)) >= 2 and int(m.group(3)) >= 1, out


def test_device_default_is_the_card(capsys, jax_db):
    """Without --device the tools ask for the card: on a host without one
    they fail instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises((AssertionError, RuntimeError)):
        search_bench.main(["--db", jax_db[0], "--count", "3", "--limit", "2"])
