"""The harness finds every configuration, cell and metric by name, and a
cell is added by adding files and entries alone."""

import json
import os
import shutil

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(name):
    c = spec.load_cell(name)
    assert c.config["n_items"] > 0 and c.traffic["batch"] > 0
    assert {"recall10_min", "dist_err_max"} <= set(c.limits)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert any(n.partition(".")[0] == "qps" for n in names)
    assert all(m["moves"] in names for m in c.per_layer)
    assert c.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(spec.metric_reader(name))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_is_its_own(entry):
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert sum(c["file"] == entry["file"] for c in BENCH["configs"]) == 1
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_an_added_file_adds_a_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    base = bench["workloads"][0]
    (root / "benchmark" / "traffic" / "exact-b512.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 512, "filter_share": None,
         "searcher": {"engine": "exact", "precision": "int8"}, "why": "test"}))
    (root / "benchmark" / "workloads" / "added-cell.json").write_text(
        json.dumps({"recall10_min": 0.99, "dist_err_max": 1e-5}))
    (root / "benchmark" / "metrics" / "added_ms.py").write_text("def read(r):\n    return 1.0\n")
    bench["workloads"].append({**base, "name": "added-cell", "traffic": "exact-b512"})
    bench["per_layer"].append({"name": "added_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "qps",
                               "workloads": ["added-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.load_cell("added-cell", root=str(root))
    assert c.traffic["batch"] == 512 and c.traffic["searcher"]["precision"] == "int8"
    assert c.config == spec.load_cell(base["name"]).config
    assert "added_ms" in [m["name"] for m in c.per_layer]
    assert spec.metric_reader("added_ms", root=str(root))({}) == 1.0
    assert "added_ms" not in [m["name"] for m in spec.load_cell(base["name"], root=str(root)).per_layer]


def test_a_dotted_metric_without_a_file_reads_as_its_base(tmp_path):
    assert spec.metric_reader("busy_ms.some_cells") is not None
    r = {"busy_s": 0.5, "requests": 100}
    assert spec.metric_reader("busy_ms.some_cells")(r) == spec.metric_reader("busy_ms")(r) == 5.0
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "metrics" / "busy_ms.own.py").write_text("def read(r):\n    return -1.0\n")
    assert spec.metric_reader("busy_ms.own", root=str(root))(r) == -1.0
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.cells")


@pytest.mark.parametrize("bad", ["../x", "a/b", "", ".hidden", "a b"])
def test_names_that_would_leave_the_folder_are_refused(bad):
    with pytest.raises((ValueError, KeyError)):
        spec.metric_reader(bad)
