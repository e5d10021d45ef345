"""The closed request loop: one client, one batch outstanding.

A request is one batch through the port's serving entry:
`Searcher.prepare_queries` (host encode and upload), `Searcher.device_fn`,
then the copy of the answers to host numpy as `Searcher.__call__` makes
it (the whole [B, w] ids and distances, cut to k on the host).  Its
latency runs from the call of `prepare_queries` to the answers on the
host.  `Searcher.__call__`'s building of Python lists is left out.
"""

from __future__ import annotations

import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Window:
    requests: int = 0
    failed: int = 0
    seconds: float = 0.0
    #: per request: latency, the prepare_queries span, and when it was
    #: answered (from the window's start), seconds
    latency_s: list = field(default_factory=list)
    done_s: list = field(default_factory=list)
    prepare_s: list = field(default_factory=list)
    #: per request: (schedule position, ids [B, k], distances [B, k])
    answers: list = field(default_factory=list)


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else nullcontext()


def drive(searcher, batches, k: int, seconds: float, start: int = 0, spans: bool = False) -> Window:
    """Send requests back to back for `seconds` (the last one sent before
    the close runs to its end), cycling through `batches` from position
    `start`.  With `spans`, each step is a `record_function` span for the
    profiler."""
    w = Window()
    clock = time.perf_counter
    t_start = clock()
    deadline = t_start + seconds
    n = start
    while clock() < deadline:
        qs = batches[n % len(batches)]
        t0 = clock()
        try:
            with _span("bench.prepare_queries", spans):
                dq = searcher.prepare_queries(qs)
            t1 = clock()
            with _span("bench.device_fn", spans):
                ids, dists = searcher.device_fn(*dq)
            with _span("bench.answers_to_host", spans):
                ids = ids.cpu().numpy()[:, :k]
                dists = dists.cpu().numpy()[:, :k]
        except Exception:  # a failed request ends the window; it is counted and shown
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
            w.requests += 1
            break
        t2 = clock()
        w.latency_s.append(t2 - t0)
        w.done_s.append(t2 - t_start)
        w.prepare_s.append(t1 - t0)
        w.answers.append((n, ids, dists))
        w.requests += 1
        n += 1
    w.seconds = clock() - t_start
    return w


def p95_ms(w: Window) -> float:
    return float(np.percentile(np.asarray(w.latency_s), 95) * 1e3)


def describe(w: Window, batch: int) -> str:
    """Latency quantiles and the rate in each quarter of the window, for the
    run's log."""
    lat = np.asarray(w.latency_s) * 1e3
    if not len(lat):
        return "no request answered"
    qs = np.percentile(lat, [50, 90, 95, 99, 100])
    edges = np.linspace(0.0, w.seconds, 5)
    counts = np.histogram(np.asarray(w.done_s), edges)[0]
    rates = counts * batch / np.diff(edges)
    return ("latency ms p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}; ".format(*qs)
            + "prepare ms mean {:.3f}; ".format(1e3 * float(np.mean(w.prepare_s)))
            + "queries/s by quarter " + " ".join(f"{r:.0f}" for r in rates))
