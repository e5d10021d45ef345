"""A run end to end at a size a CPU test holds: the result line, the
control and the planted faults that ``correct`` has to catch, and the
refusals (no card, no program, JAX loaded)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cell, run, spec, tracing
from benchmark.tests import tiny

SEED = 2_147_483_659  # past 32 signed bits: a run takes seeds of any size


@pytest.fixture(scope="module")
def exact_run():
    return cell.run(tiny.cell(), SEED, 0.5, True, "cpu", trace_seconds=0.3)


def test_the_program_is_correct_on_the_cpu(exact_run):
    assert exact_run["correct"], exact_run["checks"]
    assert exact_run["attempted"] > 1 and exact_run["failed"] == 0


#: per cell kind: its end-to-end metrics, and the per-layer ones the host's
#: readers find on the CPU (the device's find nothing there and are left out)
KINDS = {
    "glove100-exact-b2048": ({"qps.exact", "p95_ms.exact", "recall10", "setup_s"}, {"prepare_ms.exact"}),
    "glove100-probe-b2048": ({"qps.probe", "p95_ms.probe", "recall10", "setup_s"}, {"prepare_ms.probe"}),
    "dbpedia100k-traversal-b256": ({"qps.traversal", "recall10.traversal", "setup_s"},
                                   {"prepare_ms.traversal", "latency_p95_ms"}),
}


@pytest.mark.parametrize("base", sorted(KINDS))
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(exact_run, trace, base):
    line = run.result_line(tiny.cell(base=base), exact_run, 1, trace, "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert trace == ("busy_s" in line["device"] and "window_s" in line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert set(line["metrics"]) == KINDS[base][trace]
    w = exact_run["window"]
    values = {k.partition(".")[0]: v["value"] for k, v in line["metrics"].items()}
    if not trace:
        assert values["qps"] == pytest.approx(len(w.answers) * 64 / w.seconds)
        assert values.get("p95_ms", 0.0) <= 1e3 * max(w.latency_s)
    else:
        assert values["prepare_ms"] == pytest.approx(1e3 * np.mean(w.prepare_s))
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def _half_left_out(s):
    """Half of each batch left out: its rows answered by the other half's."""
    class Half:
        prepare_queries = s.prepare_queries

        def device_fn(self, qv, *rest):
            h = (qv.shape[0] + 1) // 2
            ids, d = s.device_fn(qv[:h], *(t[:h] for t in rest))
            reps = -(-qv.shape[0] // h)
            return ids.repeat(reps, 1)[: qv.shape[0]], d.repeat(reps, 1)[: qv.shape[0]]
    return Half()


def _answer_altered(s):
    """One answer a batch altered where it is produced: its first id moved
    to the next item."""
    class Altered:
        prepare_queries = s.prepare_queries

        def device_fn(self, *a):
            ids, d = s.device_fn(*a)
            ids = ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % tiny.CONFIG["n_items"]
            return ids, d
    return Altered()


def _state_unchanged(s):
    """Each request answers with the state the one before it left: the
    previous request's answers."""
    class Stale:
        prepare_queries = s.prepare_queries
        prev = None

        def device_fn(self, *a):
            out = s.device_fn(*a)
            prev, Stale.prev = Stale.prev, out
            return out if prev is None else prev
    return Stale()


@pytest.mark.parametrize("searcher", [{"engine": "auto"}, {"engine": "forest", "search_k": 3000}],
                         ids=["exact", "forest"])
@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered, _state_unchanged],
                         ids=["half", "altered", "unchanged"])
def test_a_planted_fault_is_not_correct(searcher, fault):
    res = cell.run(tiny.cell(searcher, batch=32), SEED, 0.3, False, "cpu", wrap=fault)
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct():
    res = cell.run(tiny.cell(), SEED, 0.3, False, "cpu", control=True)
    assert not res["correct"] and not res["checks"]["dist_err"]["ok"], res["checks"]


def test_the_filter_is_held():
    def unfiltered(s):
        class U:
            prepare_queries = s.prepare_queries

            def device_fn(self, *a):
                ids, d = s.device_fn(*a)
                return torch.zeros_like(ids) + torch.arange(ids.shape[1]), d
        return U()

    c = tiny.cell({"engine": "forest", "search_k": 200}, filter_share=0.2, batch=32)
    good = cell.run(c, SEED, 0.3, False, "cpu")
    assert good["checks"]["bad_answers"]["value"] == 0
    bad = cell.run(c, SEED, 0.3, False, "cpu", wrap=unfiltered)
    assert bad["checks"]["bad_answers"]["value"] > 0 and not bad["correct"]


def test_same_seed_same_inputs():
    from benchmark import data

    a = data.vectors(tiny.CONFIG, SEED, "cpu")
    b = data.vectors(tiny.CONFIG, SEED, "cpu")
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    s1, s2 = data.schedule(200, 64, SEED), data.schedule(200, 64, SEED + 1)
    assert s1.shape == s2.shape and not np.array_equal(s1, s2)
    assert sorted(np.bincount(s1.ravel(), minlength=200)) == sorted(np.bincount(s2.ravel(), minlength=200))


def test_no_jax_is_loaded_by_a_run():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import cell, run\nfrom benchmark.tests import tiny\n"
        "cell.run(tiny.cell({'engine': 'forest', 'search_k': 500}, batch=16), 5, 0.1, True, 'cpu',"
        " trace_seconds=0.1)\n"
        "print(run.forbidden_modules(), 'arroy_tpu_torch' in sys.modules)\n" % spec.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"
    sys.modules.setdefault("arroy_tpu.fake_for_test", None)
    try:
        assert run.forbidden_modules() == ["arroy_tpu"]
    finally:
        del sys.modules["arroy_tpu.fake_for_test"]


def _run_py(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "glove100-exact-b2048", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env)


def test_without_a_card_there_is_no_result():
    p = _run_py(spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    p = _run_py(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_trace_summary():
    dev = [("k1", 0.0, 10.0), ("copy", 5.0, 12.0), ("k5", 20.0, 25.0), ("k1", 40.0, 50.0)]
    host = [("bench.prepare_queries", 12.5, 19.0), ("aten::copy_", 13.0, 14.0),
            ("bench.device_fn", 26.0, 39.0)]
    s = tracing.summarize(dev, host, 1.0)
    assert s["busy_s"] == pytest.approx(27e-6) and s["n_device_events"] == 4
    assert s["device_ops"]["k1"] == (pytest.approx(20e-6), 2)
    gaps = dict((n, t) for n, t in s["breakdown"]["idle_gaps"])
    assert gaps == {"bench.prepare_queries": pytest.approx(8e-6), "bench.device_fn": pytest.approx(15e-6)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the cell runs only on the card")


@pytest.mark.gpu
def test_the_exact_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "glove100-exact-b2048", "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"], cwd=spec.ROOT, capture_output=True,
        text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
