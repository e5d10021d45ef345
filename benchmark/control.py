"""The control of ``correct``: the plain reference, computed in TF32 (the
precision just below the float32 the configurations state), put in the
program's place and judged as a run judges the program.  Its numbers set
the upper readings of the limits in ``benchmark/workloads/<cell>.json``;
the benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3

Each seed is one short window at the cell's own batch and query pool, on
the cell's own corpus size; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark import cell, spec

    c = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cell.run(c, seed, args.seconds, False, args.device, control=True)
        print(json.dumps({
            "workload": c.name, "seed": seed, "control": "reference in tf32",
            "correct": res["correct"], "attempted": res["attempted"],
            "checks": {k: v["value"] for k, v in res["checks"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
