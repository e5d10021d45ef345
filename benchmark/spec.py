"""Find a cell and its parts by name.

`BENCHMARK.json` at the repository's root names each cell's configuration
and traffic.  Each part sits in a file of its own, found by name:

- the configuration: the ``file`` its entry names
  (``benchmark/configs/<config>.json``);
- the traffic mix: ``benchmark/traffic/<traffic>.json``;
- the cell's limits for ``correct``: ``benchmark/workloads/<cell>.json``;
- each per-layer metric's reader: ``benchmark/metrics/<metric>.py``, a
  module with ``read(record) -> float | None``.

A later cell, traffic mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    #: the BENCHMARK.json entries of the metrics this cell reports
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files read."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[_checked(name)]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = os.path.normpath(os.path.join(root, configs[w["config"]]["file"]))
    if not cfg_file.startswith(os.path.join(root, "benchmark") + os.sep):
        raise ValueError(f"configuration file outside benchmark/: {cfg_file}")
    here = os.path.join(root, "benchmark")
    traffic = _json(os.path.join(here, "traffic", _checked(w["traffic"]) + ".json"))
    limits = _json(os.path.join(here, "workloads", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return Cell(name, _json(cfg_file), traffic, limits, e2e, per_layer)


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``benchmark/metrics/<name>.py``.  A metric named
    ``<base>.<cells>`` (``busy_ms.probe``: the same quantity in other cells,
    moving another end-to-end metric) with no file of its own is read by
    ``<base>.py``."""
    path = os.path.join(root, "benchmark", "metrics", _checked(name) + ".py")
    if "." in name and not os.path.exists(path):
        return metric_reader(name.partition(".")[0], root)
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
