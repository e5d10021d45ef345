#!/usr/bin/env python3
"""Recall@10 and time of the exact engine's int8 and bf16 fused modes
against the cut width ``c`` (candidates kept for the exact f32
re-score), at several corpus sizes of 768-d, on one NVIDIA GPU.

Run from the repository root:

    PYTHONPATH=. python3 scripts/torch_cut_width.py [--items N,N,...] [c ...]

Each corpus is `chip_smoke.py` phase 8's model at that size (bench.py's
clustered corpus drawn on the card, seed 42, N items and two batches of
2048 queries after them).  The reference is the f32x1 mode, which
streams past 524,288 items.  Each precision builds its fused tables
once a size; every ``c`` then runs stage 1 (kernel 1) and stage 2 with
that cut.  Times are CUDA events over the two batches after a warm-up.
Prints one JSON line per (items, precision, c), with the width
`search._cut_width` picks at that size, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np


def sweep(cs, m, widths, smi) -> None:
    """Every (precision, c) at `m` items: one JSON line each."""
    import torch

    from arroy_tpu_torch import search
    from arroy_tpu_torch.device import DeviceIndex
    from arroy_tpu_torch.metrics import metric_by_name
    from arroy_tpu_torch.models import items
    from arroy_tpu_torch.models.forest import Forest

    x = cs.card_corpus(m + cs.BATCH * cs.N_LARGE_BATCHES, cs.D, 42)
    x, queries = x[:m], x[m:]
    metric = metric_by_name("euclidean")
    store = items.ItemStore(metric, cs.D)
    store.put_many(np.arange(m), x)
    del x
    idx = DeviceIndex.build(metric, cs.D, store, Forest(), "cuda")
    del store
    dq = []
    for i in range(cs.N_LARGE_BATCHES):
        q = queries[i * cs.BATCH:(i + 1) * cs.BATCH]
        qn = metric.item_norms_np(q, cs.D)
        dq.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                        for a in (q, qn, np.zeros(len(q), np.float32))))
    ref_fn, _ = search.make_exact_fn(idx, cs.K, precision="f32x1")
    ref = np.concatenate([ref_fn(qv, qn, qe, None)[0].cpu().numpy() for qv, qn, qe in dq])
    del ref_fn
    k = cs.K
    for prec in ("int8", "bf16"):
        int8 = prec == "int8"
        tables = search._fused_tables(metric, idx.rows, idx.norms, idx.live, int8)
        for c in widths:
            def run(qv, qn, qe):
                return search._exact_fused(metric, cs.D, k, c, int8, tables, idx.rows, idx.norms,
                                           idx.extras, idx.slot_to_id, idx.live, qv, qn, qe)

            run(*dq[0])
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = [run(*d) for d in dq]
            e1.record()
            torch.cuda.synchronize()
            ids = np.concatenate([o[0].cpu().numpy() for o in out])
            print(json.dumps({"items": m, "precision": prec, "c": c,
                              "recall": cs.recall_of(ids, ref),
                              "ms_a_batch": e0.elapsed_time(e1) / len(dq), "batch": cs.BATCH,
                              "rule_c": search._cut_width(k, m), "card": smi}), flush=True)
        del tables
    del idx, dq
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--items", default="1000000", help="corpus sizes, comma-separated")
    ap.add_argument("widths", nargs="*", type=int, default=[32, 64, 128, 256, 1024])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cut_width: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for m in (int(a) for a in args.items.split(",")):
        sweep(cs, m, args.widths, smi)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
