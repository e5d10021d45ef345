"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines on standard error.  Exits non-zero
and prints no result without a CUDA device, without the program
(`arroy_tpu_torch`) in the checkout, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level module names that may not be loaded (whole names: the port's
#: own name begins with the JAX package's)
FORBIDDEN = {"jax", "jaxlib", "flax", "arroy_tpu"}


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str | None:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() else None


def result_line(c, res: dict, chips: int, trace: bool, kind: str) -> dict:
    """The result's JSON object; ``checks`` comes last."""
    from benchmark import cell as cell_mod, spec

    if trace:
        metrics = cell_mod.per_layer(c, res, spec.metric_reader)
    else:
        metrics = cell_mod.end_to_end(c, res)
    line = {
        "correct": res["correct"],
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": res["memory_peak_bytes"]},
    }
    if trace:
        rec = res["record"]
        line["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = rec["breakdown"]
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in res["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cell as cell_mod, spec

    c = spec.load_cell(args.workload)
    chips = next(w["chips"] for w in spec.load_benchmark()["workloads"] if w["name"] == c.name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"needs {chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import arroy_tpu_torch
    except ImportError as e:
        _say(f"the program is not in this checkout: {e}")
        return 2
    if not os.path.abspath(arroy_tpu_torch.__file__).startswith(ROOT + os.sep):
        _say(f"arroy_tpu_torch comes from {arroy_tpu_torch.__file__}, not from {ROOT}")
        return 2
    _say(f"card: {_power_limit() or torch.cuda.get_device_name(0)}; torch {torch.__version__}")

    res = cell_mod.run(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        _say(f"loaded in this process: {', '.join(found)}")
        return 3
    if args.trace and res.get("record") is None:
        _say("the traced segment did not run")
        return 4
    line = result_line(c, res, chips, bool(args.trace), torch.cuda.get_device_name(0))
    w = res["window"]
    _say(f"route {res['route']}; {w.requests} requests in {w.seconds:.3f} s; "
         f"setup {res['setup_s']:.3f} s; peak {res['memory_peak_bytes']} B")
    for k, v in res["checks"].items():
        _say(f"check {k} {v['value']!r} limit {v['limit']!r} {'ok' if v['ok'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout, in place of this folder: its modules are the package's
    sys.exit(main())
