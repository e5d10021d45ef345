#!/usr/bin/env python3
"""Kernel 1 (bf16): how often the tensor core's sums are promoted to f32
registers, against key agreement with the plain version and time.

The bf16 instance of `arroy_tpu_torch/csrc/fused_select.cu` sums
`kPromote` k16 steps (4: one K-slice) on the tensor core before it adds
the partial sum to f32 registers with round-to-nearest.  This script
builds a copy of the source with `kPromote` set to 4, 2 and 1 (into the
git-ignored `arroy_tpu_torch/_build/`), and for each prints:

- the share of packed keys equal to the plain version's (the check in
  `chip_smoke.py` asks for >= 98%) and max |dkey|, at the main path's
  shape (B=2048, Mp=100,352, d=768, bm=256) and at bm=1024;
- the kernel's time at the main path's shape (CUDA events, mean of 20
  launches after warm-up), beside cuBLAS's bare bf16 GEMM.

It also prints how far the plain version's own f32 GEMM (cuBLAS) lies
from dots taken in float64 and rounded once, as the scale of rounding
noise that any f32 sum carries.

Run from the repository root on a machine with a card:

    python3 scripts/torch_select_promote.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from arroy_tpu_torch.ops import _build, fused_select as fs  # noqa: E402
from chip_smoke import cuda_ms, select_inputs  # noqa: E402

PROMOTE = (4, 2, 1)
CASES = ((2048, 100_352, 768, 256), (2048, 100_352, 768, 1024), (256, 32768, 768, 256))
SETTING = "constexpr int kPromote = 4;"


def build(p: int) -> ctypes.CDLL:
    """Build fused_select.cu with kPromote = p; returns the loaded library."""
    with open(os.path.join(_build.CSRC_DIR, "fused_select.cu")) as f:
        text = f.read()
    assert SETTING in text, "fused_select.cu no longer sets kPromote as expected"
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"fused_select_p{p}.cu")
    with open(src, "w") as f:
        f.write(text.replace(SETTING, f"constexpr int kPromote = {p};"))
    so = os.path.join(_build.BUILD_DIR, f"libfused_select_p{p}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.fused_select_int8, lib.fused_select_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def keys_f64(q, x, qsc, mult, add, bm):
    """The plain version's keys with dots taken in float64, rounded once."""
    s = (q.double() @ x.double().T).float() * (qsc[:, None] * mult[None, :]) + add[None, :]
    b, mp = s.shape
    lane = torch.arange(bm, dtype=torch.int32, device=s.device)
    pk = fs._pack_keys(s.reshape(b, mp // bm, bm), lane, bm)
    m1 = pk.amax(dim=2)
    m2 = torch.where(pk == m1[:, :, None], -(2**31), pk).amax(dim=2)
    return torch.cat([m1, m2], dim=1)


def agree(a, b):
    dk = (a.long() - b.long()).abs()
    return f"{float((dk == 0).float().mean()):.5f} equal, max |dkey| {int(dk.max())}"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_select_promote: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {p: build(p) for p in PROMOTE}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for b, mp, d, bm in CASES:
        inputs = select_inputs(rng, b, mp, d, False, dev)
        rkeys, _ = fs.fused_block_select_reference(*inputs, bm=bm)
        print(f"B={b} Mp={mp} d={d} bm={bm}: plain f32 vs float64 dots: "
              f"{agree(rkeys, keys_f64(*inputs, bm))}", flush=True)
        for p, lib in libs.items():
            fs._lib = lambda lib=lib: lib
            keys, _ = fs.fused_block_select(*inputs, bm=bm)
            print(f"  promote every {p} k16 step(s): kernel vs plain {agree(keys, rkeys)}", flush=True)
    inputs = select_inputs(rng, 2048, 100_352, 768, False, dev)
    q, x = inputs[0], inputs[1]
    gemm_ms = cuda_ms(lambda: torch.matmul(q, x.t()), 20)
    for p, lib in libs.items():
        fs._lib = lambda lib=lib: lib
        ms = cuda_ms(lambda: fs.fused_block_select(*inputs), 20)
        print(f"promote every {p}: kernel {ms:.4f} ms, bare bf16 GEMM {gemm_ms:.4f} ms, "
              f"ratio {ms / gemm_ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
