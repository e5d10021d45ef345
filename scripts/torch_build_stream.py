#!/usr/bin/env python3
"""Build times of the port on the card: one checkout against another, in turns.

    PYTHONPATH=. python3 scripts/torch_build_stream.py --baseline _archive/parent \\
        [--cases fresh,budget,bq_fresh,bq_budget]

``--baseline`` is an older checkout of the repository unpacked into a
git-ignored directory (``git archive <commit> | tar -x -C _archive/parent``).
Each turn is a child process that imports `arroy_tpu_torch` from one
checkout, draws bench.py's clustered corpus on the card (64 parents, seed
42) and times `build()` with a synchronised host clock: ``fresh`` is
1,000,000 x 768 x 10 trees, ``budget`` 262,144 x 768 x 10 trees within
``available_memory(256 MiB)`` (a third of the items a batch), both
euclidean; ``bq_fresh`` and ``bq_budget`` are the same under
"binary quantized cosine", the budget 8 MiB (a BQ item is 100 bytes,
so again a third of the items a batch).  Turns run baseline, change,
change, baseline for each case.  Prints the card's name and power limit, one
JSON line a turn, then one summary line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

D, N_TREES, SEED = 768, 10, 42
BQ = "binary quantized cosine"
#: case: (items, available memory or None, metric)
CASES = {
    "fresh": (1_000_000, None, "euclidean"),
    "budget": (262_144, 256 << 20, "euclidean"),
    "bq_fresh": (1_000_000, None, BQ),
    "bq_budget": (262_144, 8 << 20, BQ),
}


def corpus(m, d, seed):
    """bench.py's clustered model on the card: each row mixes two of 64
    parents coordinate by coordinate, plus 0.05 noise."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    parents = torch.randn((64, d), generator=g, device="cuda")
    out = np.empty((m, d), np.float32)
    for s in range(0, m, 65_536):
        n = min(65_536, m - s)
        pa, pb = (torch.randint(64, (n,), generator=g, device="cuda") for _ in range(2))
        mask = torch.rand((n, d), generator=g, device="cuda") < 0.5
        x = torch.where(mask, parents[pa], parents[pb]) + 0.05 * torch.randn(
            (n, d), generator=g, device="cuda")
        out[s:s + n] = x.cpu().numpy()
    return out


def child(root: str, case: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from arroy_tpu_torch import Database, Writer

    m, memory, metric = CASES[case]
    x = corpus(m, D, SEED)
    db = Database(None, device="cuda")
    w = Writer(db, 0, D, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(m, dtype=np.uint32), x)
        torch.cuda.synchronize()
        b = w.builder(seed=SEED).n_trees(N_TREES)
        if memory is not None:
            b.available_memory(memory)
        t0 = time.perf_counter()
        b.build(wtxn)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    print(json.dumps({"root": root, "case": case, "build_s": sec}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    base = args["--baseline"]
    cases = args.get("--cases", ",".join(CASES)).split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    times: dict = {}
    for case in cases:
        for root in (base, here, here, base):
            out = subprocess.run([sys.executable, __file__, "--child", root, case],
                                 capture_output=True, text=True, check=True).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            side = "baseline" if root == base else "change"
            times.setdefault(case, {}).setdefault(side, []).append(rec["build_s"])
    print(json.dumps({"build_s": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
