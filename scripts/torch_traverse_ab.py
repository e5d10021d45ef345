#!/usr/bin/env python3
"""Kernel 4 (`arroy_tpu_torch/csrc/traverse.cu`) against an older source
of it and against cuts of its own design, in turns on one card.

1. Builds phase 7's index of `chip_smoke.py` (100,000 x 768 clustered
   corpus, seed 42, euclidean, 10 trees) and its first 2,048 queries.
2. Builds, into the git-ignored `arroy_tpu_torch/_build/`, one nvcc each,
   all started together: the shipped source; each entry of `VARIANTS`
   (a text substitution of it: the next pop's reads issued after the
   heap update, not before); and,
   with ``--baseline PATH``, an older `traverse.cu` with the interface
   before the 8-ary heap (one `smem_lanes` count, a scratch of
   B x (q_cap - smem_lanes) 8-byte slots).
3. At every timed shape of `chip_smoke.traverse_shapes` (one batch of
   256): every build bit-equal to the plain version, then CUDA-event times
   (mean of 10 calls after a warm-up) in turns: baseline, shipped,
   variants, shipped, baseline; ns a pop (ms over the longest query's
   pops) and the chain bound (those pops x one dependent L2 read,
   `ops.traverse.l2_chase`).
4. End to end, with ``--baseline``: the default traversal searcher over 8
   batches of 256 at search_k 2000 / 4000 / 8000, unfiltered and filtered
   at 10% of the ids (at least twice search_k), with the searcher's pop
   loop bound to each kernel in turns (baseline, shipped, shipped,
   baseline): ms a batch and qps.

One JSON line per shape and per searcher.  Run from the repository root
on a machine with a card:

    python3 scripts/torch_traverse_ab.py [--baseline DIR/arroy_tpu_torch/csrc/traverse.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arroy_tpu_torch import Database, Reader, Writer  # noqa: E402
from arroy_tpu_torch import search as t_search  # noqa: E402
from arroy_tpu_torch.ops import _build, traverse as tv  # noqa: E402

_READS = """      // the next pop's reads, issued before the heap is touched
      if (take_root) nrow = load_row(p, key_node(next));
      cur = nrow;
      fetch(p, mrow, cur, mg, rl, rr);
"""
_HMAX = "      hmax = hs > 0 ? h.get(0) : 0ull;\n      ++pops;\n"
#: variant -> substitutions of the shipped source (each must be there once)
VARIANTS = {
    "reads after the heap update": ((_READS, ""), (_HMAX, _HMAX + _READS)),
}
N_NEW_ARGS, N_OLD_ARGS = 23, 22


def build(tag: str, text: str, nargs: int):
    """Compile one source; returns (library, ptxas's register lines)."""
    src = os.path.join(_build.BUILD_DIR, f"traverse_{tag}.cu")
    so = os.path.join(_build.BUILD_DIR, f"libtraverse_{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.traverse.restype = ctypes.c_int
    n_int = nargs - 17  # the ints after sk_dyn: pmax, w, q_cap, out_w and the heap sizes
    lib.traverse.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong] + [ctypes.c_int] * n_int + [ctypes.c_void_p] * 5)
    info = " | ".join(line.split("ptxas info    :")[-1].strip()
                      for line in (proc.stdout + proc.stderr).splitlines()
                      if "registers" in line or "spill" in line)
    return lib, info


def variant_text(shipped: str, subs) -> str:
    for old, new in subs:
        assert shipped.count(old) == 1, (old, shipped.count(old))
        shipped = shipped.replace(old, new)
    return shipped


def call(lib, old: bool, margins, node_table, leaf_items, roots, search_k, search_k_dyn, pmax, w,
         q_cap=None, l_cap=None, filter_words=None, stats=None):
    """`ops.traverse.traverse`'s arguments and output, through ``lib``
    (with ``old``, the interface before the 8-ary heap)."""
    b, s_rows = margins.shape
    t = int(roots.shape[0])
    q_cap = t + pmax if q_cap is None else q_cap
    l_cap = min(search_k, pmax) + 1 if l_cap is None else l_cap
    dev = margins.device
    out_w = search_k + w if filter_words is not None else l_cap
    out = torch.empty((b, out_w), dtype=torch.int64, device=dev)
    pops = torch.empty(b, dtype=torch.int64, device=dev)
    n_cand = torch.empty(b, dtype=torch.int64, device=dev)
    roots = roots.to(torch.int64)
    if old:
        ns = min(q_cap, tv.SMEM_LANES)
        sizes, n_scratch = (ns,), q_cap - ns
    else:
        ns, n_scratch = tv.heap_slots(q_cap)
        sizes = (ns, n_scratch)
    scratch = torch.empty(max(b * n_scratch, 1), dtype=torch.int64, device=dev)
    rc = lib.traverse(
        margins.data_ptr(), b, s_rows, node_table.data_ptr(), node_table.shape[0],
        node_table.shape[1], leaf_items.data_ptr(), roots.data_ptr(), t,
        None if filter_words is None else filter_words.data_ptr(),
        0 if filter_words is None else filter_words.numel(), search_k_dyn, pmax, w, q_cap, out_w,
        *sizes, out.data_ptr(), pops.data_ptr(), n_cand.data_ptr(),
        scratch.data_ptr() if n_scratch else None, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "traverse")
    return out, pops, n_cand


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older traverse.cu (the binary-heap interface)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_traverse_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "traverse.cu")) as f:
        shipped = f.read()
    jobs = {"shipped": (shipped, N_NEW_ARGS)}
    jobs.update({name: (variant_text(shipped, subs), N_NEW_ARGS) for name, subs in VARIANTS.items()})
    if args.baseline:
        with open(args.baseline) as f:
            jobs["baseline"] = (f.read(), N_OLD_ARGS)
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(build, f"ab{i}", text, n)
                for i, (name, (text, n)) in enumerate(jobs.items())}
        libs = {name: fut.result() for name, fut in futs.items()}
    for name, (_, info) in libs.items():
        print(f"built {name}: {info}", flush=True)
    runners = {name: (lambda lib, old: lambda *a, **k: call(lib, old, *a, **k))(lib, name == "baseline")
               for name, (lib, _) in libs.items()}
    order = (["baseline"] if args.baseline else []) + ["shipped"] + list(VARIANTS) + ["shipped"]
    order += ["baseline"] if args.baseline else []

    rng = np.random.default_rng(42)
    x = cs.make_corpus(rng, cs.M + cs.BATCH * cs.N_BATCHES, cs.D)
    x, queries = x[:cs.M], x[cs.M:cs.M + cs.BATCH]
    tmp = tempfile.mkdtemp()
    db = Database(f"{tmp}/euclid", device="cuda")
    w = Writer(db, 0, cs.D, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(cs.M, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(cs.N_TREES).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    l2_ns = cs.l2_latency_ns(tv)
    print(f"one dependent L2 read {l2_ns:.1f} ns (pointer chase)", flush=True)

    for sh in cs.traverse_shapes(r, queries[:cs.B_PROBE]):
        if not sh["timed"]:
            continue
        want = tv.traverse_reference(*sh["args"], **sh["kw"])
        for name, run in runners.items():
            got = run(*sh["args"], **sh["kw"])
            torch.cuda.synchronize()
            for g, w_ in zip(got, want):
                assert torch.equal(g, w_), f"{name} differs from the plain version at {sh['label']}"
        pops_max = int(want[1].max())
        times = {}
        for name in order:
            times.setdefault(name, []).append(
                cs.cuda_ms(lambda: runners[name](*sh["args"], **sh["kw"]), 10))
        chain_ms = pops_max * l2_ns * 1e-6
        row = dict(search_k=sh["search_k"], filtered=sh["filtered"], shape=sh["label"],
                   pops_max=pops_max, chain_ms=chain_ms, ms=times,
                   ns_pop={k: [t * 1e6 / pops_max for t in v] for k, v in times.items()},
                   share_of_chain={k: [chain_ms / t for t in v] for k, v in times.items()})
        print(json.dumps(row), flush=True)

    if args.baseline:
        batches = [queries[i:i + cs.B_PROBE] for i in range(0, len(queries), cs.B_PROBE)]
        for sk in cs.MULTIPOP_SK:
            n_f = min(max(r.n_items() // 10, 2 * sk), r.n_items())
            cand = np.random.default_rng(5).choice(r.n_items(), n_f, replace=False)
            for filtered in (False, True):
                s = r.searcher(cs.K, search_k=sk, engine="forest",
                               candidates=cand if filtered else None)
                times = {}
                for name in ("baseline", "shipped", "shipped", "baseline"):
                    t_search.traverse = runners[name]
                    try:
                        t = {}
                        cs.run_batches(s, batches, name, t)
                    finally:
                        t_search.traverse = tv.traverse
                    times.setdefault(name, []).append(t[name])
                print(json.dumps(dict(search_k=sk, filtered=filtered, filter_ids=n_f if filtered
                                      else None, B=cs.B_PROBE, batches=len(batches), ms=times,
                                      qps={k: [cs.B_PROBE / m * 1e3 for m in v]
                                           for k, v in times.items()})), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
