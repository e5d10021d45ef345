"""Profiling hooks: Chrome traces, the program's spans, and the work each
call of kernels 3, 4 and 5 does.

Counterpart of `arroy_tpu/utils/profiling.py`.  The reference traces
build milestones with the `tracing` crate (reference:
src/writer.rs:515,609,...); the port uses `torch.profiler`.

- `trace(dir)` wraps any region (build, query loop) and writes a Chrome
  trace of it into ``dir``.
- `span(name)` marks a stage of the program, named
  ``arroy.<layer>.<stage>`` (``arroy.entry.encode``,
  ``arroy.traversal.walk``, ``arroy.bind.probe_tables``).  With nothing
  listening it costs one check.  Under any `torch.profiler` profile it is
  a host op of that name on the profiler's clock, so the host span and
  the kernels launched inside it share one timeline; its ``request`` arg
  (shown where the profile records shapes, as `trace` does) is the
  number of the request the thread is serving, which
  `Searcher.prepare_queries` advances (`next_request`).  Inside
  `recording()` the same spans are also timed on the host clock, with no
  profiler.
- `counting()` collects one work record a call of the hand kernels'
  wrappers (`ops.gather_score.work`, `ops.traverse.work`,
  `ops.rescore.work`): the shapes and the distinct rows it reads, what a
  roofline needs.  Counting reads the device, so it is off unless asked.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast

#: what `span` gives when nothing listens
_NOOP = contextlib.nullcontext()


class _Thread(threading.local):
    #: the request this thread serves (0 before its first)
    request = 0
    #: the open `recording()`'s spans, and the indices of its open spans
    spans = None
    open = None
    #: the open `counting()`'s work records
    works = None


_local = _Thread()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region; yields the profiler.

    Host operators and the program's spans are always recorded (each span
    with its request number), and CUDA kernels too when a card is present
    (its kernels, the hand-written ones included, appear by name).  On
    exit the card is synchronised, so every kernel the region queued is
    in the trace, and ``log_dir`` receives a ``*.pt.trace.json`` file that
    chrome://tracing, Perfetto and TensorBoard read."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


class _Span:
    """One span while something listens: a profiler op, a recorded
    (name, start_ns, end_ns, parent) entry, or both."""

    __slots__ = ("_name", "_op", "_spans", "_at")

    def __init__(self, name: str, profiled: bool, spans):
        self._name = name
        self._op = _RecordFunctionFast(name, (), {"request": _local.request}) if profiled else None
        self._spans = spans

    def __enter__(self):
        if self._op is not None:
            self._op.__enter__()
        if self._spans is not None:
            opened = _local.open
            self._at = len(self._spans)
            self._spans.append([self._name, time.perf_counter_ns(), 0,
                                opened[-1] if opened else None])
            opened.append(self._at)
        return self

    def __exit__(self, *exc):
        if self._spans is not None:
            self._spans[self._at][2] = time.perf_counter_ns()
            _local.open.pop()
        if self._op is not None:
            self._op.__exit__(*exc)
        return False


def span(name: str):
    """The context of the program's stage `name` (see the module's
    docstring): a shared no-op unless a profiler or a `recording()` of
    this thread listens."""
    spans = _local.spans
    profiled = torch.autograd._profiler_enabled()
    if spans is None and not profiled:
        return _NOOP
    return _Span(name, profiled, spans)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def next_request() -> int:
    """Advance this thread's request number; returns it."""
    _local.request += 1
    return _local.request


@contextlib.contextmanager
def recording():
    """Time this thread's spans on the host clock, profiler or not; yields
    a list that holds, once the context has closed, one tuple
    ``(name, start_ns, end_ns, parent)`` a span in the order they opened,
    ``parent`` the index of the enclosing span in the list (None at the
    top).  Start and end are `time.perf_counter_ns`.  Spans are kept in
    memory; a recording opened inside another takes the spans until it
    closes."""
    outer = _local.spans, _local.open
    spans = _local.spans = []
    _local.open = []
    try:
        yield spans
    finally:
        _local.spans, _local.open = outer
        spans[:] = [tuple(s) for s in spans]


@contextlib.contextmanager
def counting():
    """Collect the work records of this thread's calls of kernels 3, 4 and
    5 (one dict a call, in call order) into the list it yields.  Each
    record reads the device, so the region is slower; the calls' results
    are the same."""
    outer = _local.works
    works = _local.works = []
    try:
        yield works
    finally:
        _local.works = outer


def work_sink():
    """The open `counting()`'s list, or None: where a kernel wrapper puts
    its work record."""
    return _local.works
