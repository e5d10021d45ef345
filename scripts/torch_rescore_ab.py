#!/usr/bin/env python3
"""Kernel 5 (the exact routes' stage 2) in turns on one card: against the
plain chain it replaced, or, with ``--baseline``, against an older source
of it.

With ``--baseline PATH`` (an older `rescore.cu` with the one-regime
interface, e.g. `git show 750c2a1:arroy_tpu_torch/csrc/rescore.cu`):

1. builds that source beside the shipped one, one nvcc each, started
   together, into `arroy_tpu_torch/_build/`;
2. at every `chip_smoke.RESCORE_CASES` shape (`chip_smoke.rescore_inputs`):
   the shipped kernel, in the plan `ops.rescore._plan` gives it and forced
   into each other plan that can run the shape (`ops.rescore._plans`),
   bit-equal to the baseline (ids, their order and the distances' bits),
   and tie-aware equal to the plain version (rtol 1e-5); then device
   times (`chip_smoke.device_ms`: CUDA events around 10 calls queued
   behind a spin kernel, after a warm-up, so no host time between
   launches) in turns baseline, shipped, the other plans, shipped,
   baseline, beside the shape's bound (`chip_smoke.rescore_bound`);
3. end to end, the searchers below with stage 2 bound to either kernel,
   in turns baseline, shipped, shipped, baseline.

Without it, step 3 runs the searchers in turns plain, kernel, kernel,
plain: the plain turns bind `search.cut_rescore` / `search.rescore_topk`
to their plain versions (`ops.rescore.*_reference`, the chain of PyTorch
launches the searchers ran before kernel 5).

The searchers: `chip_smoke.py`'s exact configurations with the port
(bench.py's clustered corpus model, euclidean, 10 trees, top-10, 8
batches of 2048): 100,000 x 768 (seed 42, as `scripts/torch_profile.py
exact`) with int8, bf16 and f32x1, and 1,000,000 x 768 drawn on the card
(`chip_smoke.card_corpus`, seed 42) with int8 and bf16 fused.  Each turn
prints `scripts/torch_profile.py`'s lines (wall a batch with no profiler,
device busy a batch by `torch.profiler`, idle share, device events a
batch, the top consumers); the kernel turns check kernel 5's launches
(one a batch) and that the answers equal the other mode's (tie-aware,
rtol 1e-5).  One JSON line a shape, and a last JSON record of every
turn.  Run from the repository root on a machine with a card:

    python3 scripts/torch_rescore_ab.py [--baseline PATH] [--shapes-only] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arroy_tpu_torch.ops import _build  # noqa: E402
from arroy_tpu_torch.ops import rescore as rs  # noqa: E402
from scripts.torch_profile import N_BATCHES, profile  # noqa: E402


def build_baseline(path: str):
    """Compile an older `rescore.cu` (the one-regime interface) with the shipped
    flags; returns (library, ptxas's register lines)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "rescore_baseline.cu")
    so = os.path.join(_build.BUILD_DIR, "librescore_baseline.so")
    with open(path) as f, open(src, "w") as g:
        g.write(f.read())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.cut_rescore.restype = lib.rescore_topk.restype = ctypes.c_int
    lib.cut_rescore.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                                + [ctypes.c_void_p])
    lib.rescore_topk.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
    return lib, ptxas(proc)


def ptxas(proc) -> str:
    return ptxas_text(proc.stdout + proc.stderr)


def ptxas_text(text: str) -> str:
    """Each kernel instance's registers and spills from ptxas's report."""
    out, name = [], ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            out.append(f"{name[-60:]}: {line.split('ptxas info    :')[-1].strip()}")
    return "\n  ".join(out)


def baseline_entries(lib):
    """`ops.rescore.cut_rescore` / `rescore_topk`'s signatures, launching
    the baseline library (a CTA a query, a [B, 5c] int32 scratch past 2,048
    candidates)."""

    def run(entry, metric, dims, *args):
        normalize = True
        if len(args) == (14 if entry == "cut" else 11):
            *args, normalize = args
        if entry == "cut":
            k, c, keys, idxp, p2s, live, rows, norms, _, s2i, qv, qn, _ = args
            b, n2 = keys.shape
            c = min(c, n2)
            mid = (keys.data_ptr(), idxp.data_ptr(), p2s.data_ptr(), live.data_ptr())
        else:
            k, cand, valid, rows, norms, _, s2i, qv, qn, _ = args
            b, c = cand.shape
            mid = (cand.data_ptr(), valid.data_ptr())
        d = rows.shape[1]
        scratch = torch.empty((b, 5 * c), dtype=torch.int32, device=rows.device) \
            if c > 2048 else None
        vec = int((d * rows.element_size()) % 16 == 0 and rows.data_ptr() % 16 == 0)
        ids = torch.empty((b, k), dtype=torch.int64, device=rows.device)
        out = torch.empty((b, k), dtype=torch.float32, device=rows.device)
        head = (rs.METRICS[metric.name], rs._ROW_TYPES[rows.dtype], vec, rows.data_ptr(),
                norms.data_ptr(), s2i.data_ptr(), qv.data_ptr(), qn.data_ptr(), *mid,
                ids.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, d)
        tail = (c, k, int(normalize), torch.cuda.current_stream().cuda_stream)
        if entry == "cut":
            rc = lib.cut_rescore(*head, n2, *tail)
        else:
            rc = lib.rescore_topk(*head, *tail)
        _build.check(rc, f"baseline {entry}")
        return ids, out

    return (lambda *a, **kw: run("cut", *a, *kw.values()),
            lambda *a, **kw: run("list", *a, *kw.values()))


def forced(plan, fn):
    """`fn` (an `ops.rescore` entry) run under `plan` instead of `_plan`'s."""
    def call(*a, **kw):
        saved = rs._plan
        rs._plan = lambda *_, **__: plan
        try:
            return fn(*a, **kw)
        finally:
            rs._plan = saved
    return call


def shapes(old_cut, old_list, out):
    """Step 2 at every `RESCORE_CASES` shape."""
    corpus = cs.rescore_corpus("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cs.RESCORE_CASES:
        m, kernel, plain, name, args, work = cs.rescore_inputs(corpus, case)
        old = old_cut if name == "cut_rescore" else old_list
        kernel(m, case.d, *args)
        plan = rs.last_plan[name]
        alts = {f"as {n}": forced(p, kernel) for n, p in rs._plans(
            case.b, min(case.c, case.n2 or case.c), case.n2, case.d, case.k, sms).items()
            if p != plan}
        runs = {"baseline": old, "shipped": kernel, **alts}
        for normalize in (False, True):
            got = {n: f(m, case.d, *args, normalize=normalize) for n, f in runs.items()}
            torch.cuda.synchronize()
            bids, bd = got["baseline"]
            for n, (ids, d) in got.items():
                assert torch.equal(ids, bids), f"{case}: {n}'s ids differ from the baseline"
                assert torch.equal(d.view(torch.int32), bd.view(torch.int32)), \
                    f"{case}: {n}'s distance bits differ from the baseline"
            ids, d = got["shipped"]
        rids, rd = plain(m, case.d, *args)
        d, rd = d.cpu().numpy(), rd.cpu().numpy()
        assert np.array_equal(np.isnan(d), np.isnan(rd)), f"{case}: NaN at other places"
        atol, sgn = 0.0, 1.0
        if case.metric == "dot-product":  # q·x descends: negated, the rows ascend
            atol, sgn = 1e-7 * float(args[-2].max() * args[-6].max()), -1.0
        cs.sorted_topk_agree(ids.cpu().numpy(), sgn * d, rids.cpu().numpy(), sgn * rd, rtol=1e-5,
                             atol=atol)
        times = {}
        for n in ("baseline", "shipped", *alts, "shipped", "baseline"):
            times.setdefault(n, []).append(cs.device_ms(lambda: runs[n](m, case.d, *args), 10))
        bd_ = cs.rescore_bound(case, args[-7].element_size(), work)
        row = dict(case._asdict(), regime=plan.regime, splits=plan.splits, per_cta=plan.per_cta,
                   capped=plan.capped, valid_candidates=work["valid"],
                   distinct_rows=work["distinct"], ms=times, **bd_,
                   share_of_bound={n: [bd_["bound_ms"] / t for t in v] for n, v in times.items()})
        print(json.dumps(row), flush=True)
        out.append(row)
        del args, got, rids, rd


@contextlib.contextmanager
def stage2(mode: str, old):
    """Bind the searchers' stage 2 to kernel 5 ("kernel"), its plain
    versions ("plain") or the baseline library ("baseline")."""
    from arroy_tpu_torch import search

    saved = search.cut_rescore, search.rescore_topk
    if mode == "plain":
        search.cut_rescore, search.rescore_topk = rs.cut_rescore_reference, rs.rescore_topk_reference
    elif mode == "baseline":
        search.cut_rescore, search.rescore_topk = old
    try:
        yield
    finally:
        search.cut_rescore, search.rescore_topk = saved


def build_index(path, x):
    from arroy_tpu_torch import Database, Reader, Writer

    db = Database(path, device="cuda")
    w = Writer(db, 0, cs.D, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=42).n_trees(cs.N_TREES).build(wtxn)
    return Reader.open(db.read(), 0, db, metric="euclidean")


def turns(label, s, batches, order, old, out):
    """The searcher over `batches` in `order`; records each turn in `out`."""
    dq = s.prepare_queries(batches[0])
    answers = {}
    for i, mode in enumerate(order):
        with stage2(mode, old):
            n0 = sum(rs.launches.values())
            rec = profile(f"{label}, stage 2 {mode} (turn {i + 1})", s, batches)
            n = sum(rs.launches.values()) - n0
            ids, d = s.device_fn(*dq)
            answers[mode] = ids.cpu().numpy(), d.cpu().numpy()
        calls = 2 + 2 * len(batches)  # warm-up, timed, profiled
        assert n == (calls if mode == "kernel" else 0), f"kernel 5 launched {n} times"
        rec.update(searcher=label, stage2=mode, turn=i + 1, kernel5_launches_a_batch=n / calls)
        out.append(rec)
    a, b = (answers[m] for m in dict.fromkeys(order))
    cs.tie_aware_equal(*a, *b, rtol=1e-5)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older rescore.cu (the one-regime interface)")
    ap.add_argument("--shapes-only", action="store_true", help="skip the searchers")
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rescore_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    old = None
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with ThreadPoolExecutor(2) as ex:
        new = ex.submit(rs._lib)
        if args.baseline:
            old_lib, info = ex.submit(build_baseline, args.baseline).result()
            print(f"built the baseline:\n  {info}", flush=True)
            old = baseline_entries(old_lib)
        new.result()
    with open(os.path.join(_build.BUILD_DIR, "rescore.log")) as f:
        built = ptxas_text(f.read())
    print(f"built the shipped source:\n  {built}", flush=True)
    out = {"card": smi, "ptxas": built, "shapes": [], "turns": []}
    if old:
        shapes(*old, out["shapes"])
    if not args.shapes_only:
        order = ("baseline", "kernel", "kernel", "baseline") if old else \
            ("plain", "kernel", "kernel", "plain")
        with tempfile.TemporaryDirectory() as tmp:
            x = cs.make_corpus(np.random.default_rng(42), cs.M + cs.BATCH * N_BATCHES, cs.D)
            batches = [x[cs.M + i * cs.BATCH:cs.M + (i + 1) * cs.BATCH] for i in range(N_BATCHES)]
            r = build_index(f"{tmp}/exact", x[:cs.M])
            for prec in ("int8", "bf16", "f32x1"):
                turns(f"exact {prec}, {cs.M} x {cs.D}",
                      r.searcher(cs.K, engine="exact", precision=prec), batches, order, old,
                      out["turns"])
            del r, x
            from arroy_tpu_torch.models import items

            items._DEVICE_MIRROR.clear()
            torch.cuda.empty_cache()
            x = cs.card_corpus(cs.M_LARGE + cs.BATCH * N_BATCHES, cs.D, 42)
            batches = [x[cs.M_LARGE + i * cs.BATCH:cs.M_LARGE + (i + 1) * cs.BATCH]
                       for i in range(N_BATCHES)]
            r = build_index(None, x[:cs.M_LARGE])
            for prec in ("int8", "bf16"):
                s = r.searcher(cs.K, engine="exact", precision=prec)
                assert s.route == "fused_select", s.route
                turns(f"exact {prec}, {cs.M_LARGE} x {cs.D}", s, batches, order, old,
                      out["turns"])
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
