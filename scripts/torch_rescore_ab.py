#!/usr/bin/env python3
"""Kernel 5 (the exact routes' stage 2) against the plain chain it
replaced, end to end, in turns on one card.

Builds `chip_smoke.py`'s exact configurations with the PyTorch port
(bench.py's clustered corpus model, euclidean, 10 trees, top-10, batches
of 2048):

- 100,000 x 768 (seed 42, as `scripts/torch_profile.py exact`): the int8,
  bf16 and f32x1 searchers;
- 1,000,000 x 768 drawn on the card (`chip_smoke.card_corpus`, seed 42):
  the int8 and bf16 fused searchers.

Each searcher runs 8 batches in turns plain, kernel, kernel, plain: the
plain turns bind `search.cut_rescore` / `search.rescore_topk` to their
plain versions (`ops.rescore.*_reference`, the chain of PyTorch launches
the searchers ran before kernel 5), the kernel turns to the kernel.
Each turn prints `scripts/torch_profile.py`'s lines (wall a batch with
no profiler, device busy a batch by `torch.profiler`, idle share, device
events a batch, the top consumers), and the kernel turns check kernel
5's launches (one a batch) and that the answers equal the plain turn's
(tie-aware, rtol 1e-5).  The last line is one JSON record of every turn.

    python3 scripts/torch_rescore_ab.py
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import BATCH, D, K, M, M_LARGE, N_TREES, card_corpus, make_corpus, tie_aware_equal  # noqa: E402
from scripts.torch_profile import N_BATCHES, profile  # noqa: E402

TURNS = ("plain", "kernel", "kernel", "plain")


@contextlib.contextmanager
def stage2(mode: str):
    """Bind the searchers' stage 2 to kernel 5 or to its plain versions."""
    from arroy_tpu_torch import search
    from arroy_tpu_torch.ops import rescore as rs

    saved = search.cut_rescore, search.rescore_topk
    if mode == "plain":
        search.cut_rescore, search.rescore_topk = rs.cut_rescore_reference, rs.rescore_topk_reference
    try:
        yield
    finally:
        search.cut_rescore, search.rescore_topk = saved


def build(path, x):
    from arroy_tpu_torch import Database, Reader, Writer

    db = Database(path, device="cuda")
    w = Writer(db, 0, D, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x), dtype=np.uint32), x)
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
    return Reader.open(db.read(), 0, db, metric="euclidean")


def turns(label, s, batches, out):
    """The searcher over `batches` in `TURNS`; records each turn in `out`."""
    from arroy_tpu_torch.ops import rescore as rs

    dq = s.prepare_queries(batches[0])
    answers = {}
    for i, mode in enumerate(TURNS):
        with stage2(mode):
            n0 = sum(rs.launches.values())
            rec = profile(f"{label}, stage 2 {mode} (turn {i + 1})", s, batches)
            n = sum(rs.launches.values()) - n0
            ids, d = s.device_fn(*dq)
            answers[mode] = ids.cpu().numpy(), d.cpu().numpy()
        calls = 2 + 2 * len(batches)  # warm-up, timed, profiled
        assert n == (calls if mode == "kernel" else 0), f"kernel 5 launched {n} times"
        rec.update(searcher=label, stage2=mode, turn=i + 1,
                   kernel5_launches_a_batch=n / calls)
        out.append(rec)
    tie_aware_equal(*answers["kernel"], *answers["plain"], rtol=1e-5)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        x = make_corpus(np.random.default_rng(42), M + BATCH * N_BATCHES, D)
        batches = [x[M + i * BATCH:M + (i + 1) * BATCH] for i in range(N_BATCHES)]
        r = build(f"{tmp}/exact", x[:M])
        for prec in ("int8", "bf16", "f32x1"):
            turns(f"exact {prec}, {M} x {D}", r.searcher(K, engine="exact", precision=prec),
                  batches, out)
        del r, x
        from arroy_tpu_torch.models import items

        items._DEVICE_MIRROR.clear()
        torch.cuda.empty_cache()
        x = card_corpus(M_LARGE + BATCH * N_BATCHES, D, 42)
        batches = [x[M_LARGE + i * BATCH:M_LARGE + (i + 1) * BATCH] for i in range(N_BATCHES)]
        r = build(None, x[:M_LARGE])
        for prec in ("int8", "bf16"):
            s = r.searcher(K, engine="exact", precision=prec)
            assert s.route == "fused_select", s.route
            turns(f"exact {prec}, {M_LARGE} x {D}", s, batches, out)
    print(json.dumps({"card": smi, "turns": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
