#!/usr/bin/env python3
"""Near-ties at the k-th place of kernel 5's dot-product test inputs.

`tests/test_torch_cuda.py::test_cuda_kernel5_regimes_match_plain` holds
kernel 5 to its plain version with `tie_aware_equal`, which lets two
distances within the tolerance come back in either order, and exempts a
row's boundary (the k-th against the (k+1)-th) only at the row's largest
value.  Normalized dot-product rows descend (q·x), so `_check_stage2`
negates them first.  This script draws that test's inputs for its cut
cases at B = 924 and 923 (c = 32, k = 10, seed c + k), runs the plain
version for the top k + 1, and prints each row whose k-th and (k+1)-th
distances lie within the test's tolerance (rtol 1e-5, atol 1e-7 of
|q|·|x| at their largest): the rows where an exact kernel may keep
either candidate.  Run from the repository root, on the card or the CPU:

    python3 scripts/torch_rescore_ties.py [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from arroy_tpu_torch.ops import rescore as rs  # noqa: E402
from tests.test_torch_cuda import _cut_inputs, _stage2_inputs  # noqa: E402

CASES = ((924, 784, 32, 10), (923, 784, 32, 10))


def near_ties(dev, b, n2, c, k):
    s = _stage2_inputs(dev, "dot-product", b, 100_000, 768, live_share=0.9, seed=c + k,
                       zero_rows=True)
    keys, idxp, p2s = _cut_inputs(s, b, n2)
    ids, d = rs.cut_rescore_reference(
        s["metric"], s["dims"], k + 1, c, keys, idxp, p2s, s["live"], s["rows"], s["norms"],
        s["extras"], s["slot_to_id"], s["qv"], s["qn"], s["qe"])
    atol = max(1e-6, 1e-7 * float(s["qv"].norm(dim=1).max() * s["norms"].max()))
    d, ids = d.cpu().double(), ids.cpu()
    kth, nxt = d[:, k - 1], d[:, k]
    tol = atol + 1e-5 * nxt.abs()
    rows = torch.nonzero(torch.isfinite(nxt) & ((kth - nxt).abs() <= tol)).flatten().tolist()
    return dict(B=b, n2=n2, c=c, k=k, atol=atol, rows=[
        dict(row=r, kth=float(kth[r]), next=float(nxt[r]), gap=float(kth[r] - nxt[r]),
             tol=float(tol[r]), ids=[int(ids[r, k - 1]), int(ids[r, k])]) for r in rows])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    dev = ap.parse_args().device
    for case in CASES:
        print(json.dumps(dict(device=dev, **near_ties(dev, *case))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
