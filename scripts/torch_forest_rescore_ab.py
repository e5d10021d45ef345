#!/usr/bin/env python3
"""Kernel 5 in the forest engines, in turns with the plain chains it
replaced, on one card.

1. At every `chip_smoke.FOREST_CASES` shape (the probe's stage 3 at B = 256
   and c = 512 / 1,000 / 4,000, f32 and bf16 rows, 25% repeats marked
   dead; the traversal's re-score at B = 1 and 16 with c = cap at search_k
   2000 and 8000): the kernel in the plan `ops.rescore._plan` gives it and
   forced into each other plan that can run it (`ops.rescore._plans`), all
   bit-equal (ids, order, distance bits) and tie-aware equal to the plain
   version (rtol 1e-5); device ms (`chip_smoke.device_ms`: 10 calls queued
   behind a spin kernel) in turns shipped, the other plans, shipped, beside
   the bound (`chip_smoke.rescore_bound`: each distinct valid row read
   once) and the plain version's ms.
2. The searchers, in turns plain, kernel, kernel, plain (the plain turns
   run `chip_smoke.plain_forest_rescore`): the probe over 262,144 x 768
   (`chip_smoke.py` phase 6's corpus, 8 batches of 256) with bf16 tables at
   search_k 4000 and 8000 and int8 tables at 4000; the traversal over
   100,000 x 768 (phase 4's corpus) through `nns().by_vector` (B = 1, 64
   queries) and `searcher(engine="forest")` at B = 16 (4 batches), at
   search_k 2000, 4000 and 8000, unfiltered and filtered at 10% of the
   ids (at least twice search_k), each re-scoring per candidate
   (`rescore="exact"` where B · cap passes the corpus).  Each turn: wall a
   call (host clock, no profiler, ending in `synchronize` or in `nns()`'s
   own read of its answers), device busy a call and device events a call
   (`torch.profiler`, device-side events only), the idle share (1 - busy /
   wall), kernel 5's launches a call (1 in the kernel turns, 0 in the
   plain ones); the kernel turns' answers tie-aware equal to the plain
   turns' (rtol 1e-5).

One JSON line a shape and a turn, and a last JSON record of all of them.
Run from the repository root on a machine with a card:

    python3 scripts/torch_forest_rescore_ab.py [--shapes-only] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arroy_tpu_torch.ops import rescore as rs  # noqa: E402
from scripts.torch_rescore_ab import build_index, forced  # noqa: E402

TURNS = ("plain", "kernel", "kernel", "plain")
#: the probe's configurations: (table type, search_k)
PROBE_RUNS = (("auto", 4000), ("auto", 8000), ("int8", 4000))


def shapes(out):
    """Step 1 at every `FOREST_CASES` shape."""
    corpus = cs.rescore_corpus("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cs.FOREST_CASES:
        m, kernel, plain, name, args, work = cs.rescore_inputs(corpus, case)
        kernel(m, case.d, *args)
        plan = rs.last_plan[name]
        runs = {"shipped": kernel, **{f"as {n}": forced(p, kernel) for n, p in rs._plans(
            case.b, case.c, None, case.d, case.k, sms).items() if p != plan}}
        for normalize in (False, True):
            got = {n: f(m, case.d, *args, normalize=normalize) for n, f in runs.items()}
            torch.cuda.synchronize()
            ids, d = got["shipped"]
            for n, (i, dd) in got.items():
                assert torch.equal(i, ids), f"{case}: {n}'s ids differ from the shipped plan's"
                assert torch.equal(dd.view(torch.int32), d.view(torch.int32)), \
                    f"{case}: {n}'s distance bits differ from the shipped plan's"
        rids, rd = plain(m, case.d, *args)
        cs.sorted_topk_agree(ids.cpu().numpy(), d.cpu().numpy(), rids.cpu().numpy(),
                             rd.cpu().numpy(), rtol=1e-5, atol=0.0)
        times = {}
        for n in ("shipped", *[n for n in runs if n != "shipped"], "shipped"):
            times.setdefault(n, []).append(cs.device_ms(lambda: runs[n](m, case.d, *args), 10))
        plain_ms = cs.device_ms(lambda: plain(m, case.d, *args), 3)
        bd = cs.rescore_bound(case, args[-7].element_size(), work)
        row = dict(case._asdict(), regime=plan.regime, splits=plan.splits, per_cta=plan.per_cta,
                   capped=plan.capped, valid_candidates=work["valid"],
                   distinct_rows=work["distinct"], ms=times, plain_ms=plain_ms, **bd,
                   share_of_bound={n: [bd["bound_ms"] / t for t in v] for n, v in times.items()})
        print(json.dumps(row), flush=True)
        out.append(row)
        del args, got, rids, rd


def measure(label, calls, expect):
    """Wall, device busy and events a call over `calls` (thunks returning
    answers as numpy), after two warm-up calls; checks kernel 5's launches
    (`expect` a call).  Returns (the record, the answers)."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    n0 = rs.launches["rescore_topk"]
    t0 = time.perf_counter()
    answers = [c() for c in calls]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(calls)
    n = (rs.launches["rescore_topk"] - n0) / len(calls)
    assert n == expect, f"{label}: kernel 5 launched {n} times a call"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for c in calls:
            c()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / len(calls)
    k5 = sum(e.self_device_time_total for e in ev if "rescore_kernel" in e.key) / 1e3 / len(calls)
    rec = dict(label=label, wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
               device_events=sum(e.count for e in ev) / len(calls), kernel5_ms=k5,
               kernel5_launches=n)
    print(json.dumps(rec), flush=True)
    return rec, answers


def in_turns(label, calls, out):
    """`measure` in turns plain, kernel, kernel, plain; the kernel turns'
    answers tie-aware equal to the plain turns'."""
    answers = {}
    for i, mode in enumerate(TURNS):
        with cs.plain_forest_rescore() if mode == "plain" else contextlib.nullcontext():
            rec, got = measure(f"{label}, {mode} (turn {i + 1})", calls, int(mode == "kernel"))
        rec.update(searcher=label, mode=mode, turn=i + 1)
        out.append(rec)
        answers[mode] = tuple(np.concatenate(a) for a in zip(*got))
    cs.tie_aware_equal(*answers["kernel"], *answers["plain"], rtol=1e-5)


def device_answers(s, dq):
    def call():
        ids, d = s.device_fn(*dq)
        return ids[:, :cs.K].cpu().numpy(), d[:, :cs.K].cpu().numpy()
    return call


def probe_turns(tmp, out):
    x = cs.make_corpus(np.random.default_rng(42), cs.M_PROBE + cs.B_PROBE * cs.N_PROBE_BATCHES,
                       cs.D)
    batches = [x[cs.M_PROBE + i * cs.B_PROBE:cs.M_PROBE + (i + 1) * cs.B_PROBE]
               for i in range(cs.N_PROBE_BATCHES)]
    r = build_index(f"{tmp}/probe", x[:cs.M_PROBE])
    for dtype, sk in PROBE_RUNS:
        s = r.searcher(cs.K, search_k=sk, engine="forest", probe_dtype=dtype)
        assert s.route == "probe", s.route
        kind = str(s.device_fn.tables.blk_rows.dtype).replace("torch.", "")
        in_turns(f"probe {kind} tables, search_k {sk}, k2 {s.device_fn.k2}, {cs.M_PROBE} x "
                 f"{cs.D}, B={cs.B_PROBE}", [device_answers(s, s.prepare_queries(b))
                                             for b in batches], out)


def traversal_turns(tmp, out):
    x = cs.make_corpus(np.random.default_rng(42), cs.M + cs.BATCH * cs.N_BATCHES, cs.D)
    q = x[cs.M:cs.M + cs.SMALL_QUERIES]  # phase 7's first queries
    r = build_index(f"{tmp}/exact", x[:cs.M])
    for sk in cs.MULTIPOP_SK:
        n_f = min(max(cs.M // 10, 2 * sk), cs.M)
        cand = np.random.default_rng(5).choice(cs.M, n_f, replace=False)
        for filt in (None, cand):
            what = "" if filt is None else f", filtered {n_f} ids"
            qb = r.nns(cs.K).search_k(sk)
            if filt is not None:
                qb = qb.candidates(filt)
            in_turns(f"nns().by_vector, search_k {sk}{what}, {cs.M} x {cs.D}, B=1",
                     [lambda v=v: cs.result_arrays([qb.by_vector(v)]) for v in q], out)
            s = r.searcher(cs.K, search_k=sk, engine="forest", candidates=filt)
            rescore = "auto"
            if s.device_fn.rescore_mode(cs.SMALL_B) != "exact":
                rescore = "exact"
                s = r.searcher(cs.K, search_k=sk, engine="forest", candidates=filt,
                               rescore="exact")
            in_turns(f"traversal, search_k {sk}{what}, rescore {rescore}, cap {s.device_fn.cap}, "
                     f"{cs.M} x {cs.D}, B={cs.SMALL_B}",
                     [device_answers(s, s.prepare_queries(q[i:i + cs.SMALL_B]))
                      for i in range(0, len(q), cs.SMALL_B)], out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes-only", action="store_true", help="skip the searchers")
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_forest_rescore_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rs._lib()
    out = {"card": smi, "shapes": [], "turns": []}
    shapes(out["shapes"])
    if not args.shapes_only:
        with tempfile.TemporaryDirectory() as tmp:
            traversal_turns(tmp, out["turns"])
            probe_turns(tmp, out["turns"])
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
