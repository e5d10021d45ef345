"""The port's spans, set-up recording and kernel work records
(`utils.profiling`), on the CPU routes.

- Under `torch.profiler`, a request through each engine (the exact
  engine's fused route, the traversal, the leaf probe, the filtered
  traversal) emits its ``arroy.*`` stage spans, nested as the engines
  call them, every span of one request carrying that request's number.
- With no profiler and no recording, no profiler op is entered.
- `recording()` hands back the set-up's spans: `Writer.add_items`, the
  build and one child a main step, the bind and its tables.
- The work records of kernels 3, 4 and 5 match hand counts, and a search
  answers bit for bit the same inside `counting()` as outside.
"""

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch.ops import gather_score, rescore, traverse
from arroy_tpu_torch.ops.fused_select import DEAD_KEY_MAX
from arroy_tpu_torch.utils import profiling

#: 4,400 items: the fused route needs 32 select blocks of 256 (4,096+)
N, DIM, TREES, K = 4400, 16, 4, 10
SEARCHERS = {
    "exact": dict(),
    "traversal": dict(engine="forest", search_k=400, traversal="xla"),
    "probe": dict(engine="forest", search_k=400, traversal="probe"),
    "filtered": dict(engine="forest", search_k=400, traversal="xla",
                     candidates=np.arange(0, N, 3)),
}
#: each engine's spans of one request -> the span that holds each
ENTRY = {"arroy.entry.prepare": None, "arroy.entry.encode": "arroy.entry.prepare",
         "arroy.entry.upload": "arroy.entry.prepare"}
TRAVERSAL = {"arroy.traversal": None, **{f"arroy.traversal.{s}": "arroy.traversal"
                                         for s in ("margins", "walk", "expand", "rescore")}}
NESTING = {
    "exact": {**ENTRY, "arroy.exact.fused_select": None,
              "arroy.exact.select": "arroy.exact.fused_select",
              "arroy.exact.rescore": "arroy.exact.fused_select"},
    "traversal": {**ENTRY, **TRAVERSAL},
    "probe": {**ENTRY, "arroy.probe": None, **{f"arroy.probe.{s}": "arroy.probe"
                                               for s in ("rank", "score", "cut", "rescore")}},
    "filtered": {**ENTRY, **TRAVERSAL},
}
#: the kernel wrappers each engine calls, in its work records
KERNELS = {"exact": {"cut_rescore"}, "traversal": {"traverse"},
           "probe": {"rank_select", "gather_score"}, "filtered": {"traverse"}}


def _vectors():
    return np.random.default_rng(7).standard_normal((N, DIM)).astype(np.float32)


def _index(x):
    db = Database(None, device="cpu")
    w = Writer(db, 0, DIM, metric="cosine")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(N), x)
        w.builder(seed=3).n_trees(TREES).build(wtxn)
    return db, Reader.open(db.read(), 0, db, metric="cosine")


@pytest.fixture(scope="module")
def served():
    x = _vectors()
    _, r = _index(x)
    searchers = {name: r.searcher(K, **kw) for name, kw in SEARCHERS.items()}
    assert searchers["exact"].route == "fused_select"
    assert searchers["probe"].route == "probe" and searchers["traversal"].route == "traversal"
    return x[:8] + 0.01, searchers


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end, e.kwinputs.get("request"))
            for e in prof.events() if e.name.startswith("arroy.")]


def _parents(spans):
    """Each span's name -> the name of the narrowest other span holding it."""
    out = {}
    for i, (n, s, e, _) in enumerate(spans):
        holders = [(e2 - s2, s2, n2) for j, (n2, s2, e2, _) in enumerate(spans)
                   if j != i and s2 <= s and e <= e2]
        out[n] = min(holders)[2] if holders else None
    return out


@pytest.mark.parametrize("engine", sorted(SEARCHERS))
def test_spans_nest_and_carry_the_request(served, engine):
    q, searchers = served
    s = searchers[engine]
    spans = _profiled(lambda: s.device_fn(*s.prepare_queries(q)))
    assert _parents(spans) == NESTING[engine]
    (req,) = {r for *_, r in spans}
    again = _profiled(lambda: s.device_fn(*s.prepare_queries(q)))
    assert {r for *_, r in again} == {req + 1}


def test_no_profiler_op_without_a_listener(served, monkeypatch):
    q, searchers = served
    entered = []

    class Counted:
        def __init__(self, *a):
            entered.append(a[0])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Counted)
    _, r = _index(_vectors())
    for name, kw in SEARCHERS.items():
        s = r.searcher(K, **kw)
        s.device_fn(*s.prepare_queries(q))
    assert entered == []
    assert profiling.span("arroy.test") is profiling.span("arroy.test.other")
    _profiled(lambda: searchers["probe"].device_fn(*searchers["probe"].prepare_queries(q)))
    assert "arroy.probe.rank" in entered


def test_recording_returns_the_setup_spans():
    x = _vectors()
    with profiling.recording() as spans:
        db, r = _index(x)
        r.searcher(K)
        r.searcher(K, engine="forest", search_k=400, traversal="probe")
    assert spans, "no span recorded"
    names = [n for n, *_ in spans]
    at = {n: i for i, n in reversed(list(enumerate(names)))}  # first index of each name
    parent = {n: (None if p is None else names[p]) for n, _, _, p in spans}
    assert parent["arroy.add_items"] is None and parent["arroy.build"] is None
    steps = [n for n in names if n.startswith("arroy.build.")]
    assert steps[0] == "arroy.build.pre_processing_the_items"
    assert {"arroy.build.create_trees_for_items", "arroy.build.write_the_metadata"} <= set(steps)
    assert all(parent[n] == "arroy.build" for n in steps)
    assert names.count("arroy.bind") == 2 and parent["arroy.bind"] is None
    assert parent["arroy.bind.device_index"] == "arroy.bind"
    assert parent["arroy.bind.fused_tables"] == "arroy.bind"
    assert parent["arroy.bind.probe_tables"] == "arroy.bind"
    assert parent["arroy.bind.probe_pack"] == "arroy.bind.probe_tables"
    assert spans[at["arroy.bind.fused_tables"]][3] == at["arroy.bind"]
    for n, s, e, p in spans:
        assert s <= e
        if p is not None:
            assert spans[p][1] <= s and e <= spans[p][2]
    # the steps follow each other inside the build
    bounds = [(s, e) for n, s, e, _ in spans if n.startswith("arroy.build.")]
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(bounds, bounds[1:]))
    n_closed = len(spans)
    r.searcher(K)
    assert len(spans) == n_closed


def test_gather_score_work_counts_distinct_blocks():
    rows = torch.zeros((10, 4, 8), dtype=torch.bfloat16)
    bid = torch.tensor([[0, 3, 3], [9, 0, 1]], dtype=torch.int32)
    assert gather_score.work(rows, bid) == {
        "kernel": "gather_score", "B": 2, "C": 3, "P": 4, "d": 8, "dtype": "bfloat16",
        "elem_bytes": 2, "blocks": 4}


def test_traverse_work_counts_pops():
    w = traverse.work(torch.tensor([3, 7, 0]), True)
    assert w == {"kernel": "traverse", "B": 3, "filtered": True, "pops_max": 7, "pops_total": 10}
    assert traverse.work(torch.zeros(0, dtype=torch.int64), False)["pops_max"] == 0


def test_rescore_work_counts_distinct_valid_rows():
    rows = torch.zeros((8, 5))
    cand = torch.tensor([[0, 1, 2], [2, 2, 5]])  # valid: 0, 1 and 2, 5
    valid = torch.tensor([[True, True, False], [True, False, True]])
    assert rescore.work("rescore_topk", 2, cand, valid, rows) == {
        "kernel": "rescore_topk", "B": 2, "c": 3, "n2": None, "d": 5, "k": 2,
        "dtype": "float32", "elem_bytes": 4, "valid": 4, "rows": 4}


def test_cut_rescore_records_the_key_cut():
    """Two queries' keys: the top 3 of 4, dead keys not valid, a dead slot
    not valid; the rows read are the distinct valid slots."""
    dead = DEAD_KEY_MAX
    keys = torch.tensor([[50, 40, dead, 30], [dead, 60, 70, dead - 5]], dtype=torch.int32)
    idxp = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 0]], dtype=torch.int32)
    pos_to_slot = torch.tensor([4, 2, 0, 2])
    live = torch.tensor([True, True, True, True, False])
    cand, valid = rescore.key_cut(3, keys, idxp, pos_to_slot, live)
    assert cand.tolist() == [[4, 2, 2], [2, 0, 2]]
    assert valid.tolist() == [[False, True, True], [True, True, False]]
    rows = torch.randn(5, 6)
    q = torch.randn(2, 6)
    from arroy_tpu_torch.metrics import resolve_metric

    m = resolve_metric("euclidean")
    with profiling.counting() as works:
        rescore.cut_rescore(m, 6, 1, 3, keys, idxp, pos_to_slot, live, rows, torch.ones(5),
                            torch.zeros(5), torch.arange(5), q, torch.ones(2), torch.zeros(2))
    assert works == [{"kernel": "cut_rescore", "B": 2, "c": 3, "n2": 4, "d": 6, "k": 1,
                      "dtype": "float32", "elem_bytes": 4, "valid": 4, "rows": 2}]


@pytest.mark.parametrize("engine", sorted(SEARCHERS))
def test_counting_leaves_the_answers_bit_equal(served, engine):
    q, searchers = served
    s = searchers[engine]
    ids, d = s.device_fn(*s.prepare_queries(q))
    with profiling.counting() as works:
        ids2, d2 = s.device_fn(*s.prepare_queries(q))
    assert torch.equal(ids, ids2) and torch.equal(d, d2)
    assert works and {w["kernel"] for w in works} == KERNELS[engine]
    assert all(w["B"] == len(q) for w in works)
    if engine in ("traversal", "filtered"):
        assert works[-1]["pops_total"] == int(s.device_fn.last_pops.sum())
        assert works[-1]["filtered"] == (engine == "filtered")
    with profiling.counting() as none:
        pass
    s.device_fn(*s.prepare_queries(q))
    assert none == []
