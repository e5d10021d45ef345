"""Generate a synthetic vector corpus by crossover of seed vectors.

Reference: examples/sample_vectors.rs — derive a large corpus from a few
random parents so the data has cluster structure rather than pure noise.
The corpus is drawn with numpy on the host, so it is the JAX tool's
output byte for byte; ``--device`` is accepted for a uniform command
line and touches no device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ._common import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--count", type=int, default=10_000)
    ap.add_argument("--dimensions", type=int, default=768)
    ap.add_argument("--parents", type=int, default=32)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("-o", "--output", default="-", help="'-' for stdout lines, or a .npy path")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    parents = rng.standard_normal((args.parents, args.dimensions)).astype(np.float32)
    # crossover: each child takes each coordinate from one of two parents
    pa = rng.integers(args.parents, size=args.count)
    pb = rng.integers(args.parents, size=args.count)
    mask = rng.random((args.count, args.dimensions)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    x += args.noise * rng.standard_normal(x.shape).astype(np.float32)

    if args.output.endswith(".npy"):
        np.save(args.output, x)
        print(f"wrote {x.shape} to {args.output}", file=sys.stderr)
    else:
        for row in x:
            sys.stdout.write(" ".join(f"{v:.6f}" for v in row) + "\n")


if __name__ == "__main__":
    main()
