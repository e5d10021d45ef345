"""One run of one cell: set-up, the measured window, the optional traced
segment, then the comparison with the reference.

Set-up (timed as ``setup_s``, from the process's start): the corpus and
query pool drawn on the device from the seed, `Writer.add_items` into an
in-memory `Database(path=None, device=...)`, `ArroyBuilder.build` of the
configuration's trees, `Reader.searcher` bound with the traffic's
arguments, and warm-up requests of the traffic's own batch shape.  The
reference runs after the window, once the device's peak memory has been
read and the program's state is freed; it is not part of ``setup_s``.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import checks, data, loop, reference, tracing

#: requests sent before the window (every batch of a traffic has one shape)
WARMUP_REQUESTS = 3


class ControlSearcher:
    """The control: the plain reference in the program's place, computed
    in TF32 (`reference.topk(precision="tf32")`), behind the searcher's
    serving interface."""

    def __init__(self, x: np.ndarray, metric: str, k: int, allowed, device):
        self.device = torch.device(device)
        self.x = torch.from_numpy(x).to(self.device)
        self.metric, self.k = metric, k
        self.mask = None
        if allowed is not None:
            self.mask = torch.zeros(len(x), dtype=torch.bool, device=self.device)
            self.mask[torch.from_numpy(allowed).to(self.device)] = True

    def prepare_queries(self, vectors):
        return (torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(self.device),)

    def device_fn(self, q):
        return reference.topk(self.x, q, self.k, self.metric, "tf32", self.mask)


def _build(cfg: dict, x: np.ndarray, seed: int, device):
    from arroy_tpu_torch import Database, Reader, Writer

    db = Database(None, device=device)
    w = Writer(db, 0, cfg["dims"], metric=cfg["metric"])
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=int(seed)).n_trees(cfg["n_trees"]).build(wtxn)
    return db, Reader.open(db.read(), 0, db, metric=cfg["metric"])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        control: bool = False, wrap=None, trace_seconds: float = tracing.SECONDS) -> dict:
    """One run of `cell` (a `spec.Cell`): ``correct``, attempted and failed
    requests, the checks, the device's peak bytes, ``setup_s``, the
    measured `loop.Window`, and with `trace` the traced segment's
    ``record`` for the per-layer readers.  `control` puts the reference in
    TF32 in the program's place; `wrap(searcher)` may replace the searcher
    (a test's planted fault)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the generator drives a closed loop with one client")
    k, b = cfg["k"], traffic["batch"]
    phases = [("start", time.perf_counter())]
    x, pool = data.vectors(cfg, seed, device)
    sched = data.schedule(len(pool), b, seed)
    batches = [np.ascontiguousarray(pool[i]) for i in sched]
    allowed = data.filter_ids(len(x), traffic["filter_share"], seed) \
        if traffic.get("filter_share") else None
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    phases.append(("data", time.perf_counter()))
    db = reader = None
    if control:
        searcher = ControlSearcher(x, cfg["metric"], k, allowed, device)
    else:
        db, reader = _build(cfg, x, seed, device)
        phases.append(("add_items+build", time.perf_counter()))
        searcher = reader.searcher(k, candidates=allowed, **traffic["searcher"])
    phases.append(("searcher", time.perf_counter()))
    if wrap is not None:
        searcher = wrap(searcher)
    for i in range(WARMUP_REQUESTS):
        dq = searcher.prepare_queries(batches[i % len(batches)])
        ids, dists = searcher.device_fn(*dq)
        ids.cpu(), dists.cpu()
    _sync(device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print(f"set-up: process start to the cell {phases[0][1] - t_start:.3f} s, " + ", ".join(
        f"{n} {t - t0:.3f} s" for (_, t0), (n, t) in zip(phases, phases[1:])), file=sys.stderr)

    window = loop.drive(searcher, batches, k, seconds)
    print(f"window: {loop.describe(window, b)}", file=sys.stderr)
    traced = summary = None
    if trace and not window.failed:
        traced, summary = tracing.traced_segment(
            lambda s, spans: loop.drive(searcher, batches, k, s, start=window.requests, spans=spans),
            device, trace_seconds,
        )
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    route = getattr(searcher, "route", "control")
    del searcher, reader, db
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    answers = window.answers + (traced.answers if traced else [])
    judged = checks.judge(answers, sched, x, pool, cfg["metric"], k, cell.limits, allowed, device)
    failed = window.failed + (traced.failed if traced else 0)
    attempted = window.requests + (traced.requests if traced else 0)
    out = {
        "correct": failed == 0 and all(c["ok"] for c in judged.values()),
        "attempted": attempted,
        "failed": failed,
        "checks": judged,
        "memory_peak_bytes": int(peak),
        "route": route,
        "window": window,
        "setup_s": setup_s,
    }
    if trace and summary is not None:
        record = dict(summary)
        record.update(
            requests=traced.requests,
            batch=b, n_items=len(x), dims=cfg["dims"],
            loop_requests=window.requests, loop_seconds=window.seconds,
            prepare_s=window.prepare_s, latency_s=window.latency_s,
        )
        out["record"] = record
    return out


def end_to_end(cell, res: dict) -> dict:
    """The cell's end-to-end metrics from a run's parts.  A metric named
    ``<base>.<cells>`` (``qps.traversal``) is ``<base>`` under a bound of
    its own for the cells it lists."""
    w = res["window"]
    values = {
        "qps": len(w.answers) * cell.traffic["batch"] / w.seconds,
        "p95_ms": loop.p95_ms(w) if w.latency_s else float("nan"),
        "recall10": res["checks"]["recall10"]["value"],
        "setup_s": res["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"].partition(".")[0]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, res: dict, reader_of) -> dict:
    """The cell's per-layer metrics its readers find in the trace."""
    out = {}
    for m in cell.per_layer:
        v = reader_of(m["name"])(res["record"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
