#!/usr/bin/env python3
"""Kernel 2 (`arroy_tpu_torch/csrc/hamming.cu`): the card's one-bit MMA
rate, and the kernel's settings, chosen by measuring.

1. Builds `scripts/mma_rate.cu` and times loops of `mma.sync`
   m16n8k256 .b1 (.and.popc) and m16n8k32 .s8 on every SM: MMAs per SM
   per microsecond and tera-operations per second (two per bit or
   multiply-add).
2. Builds a copy of `hamming.cu` for each entry of `VARIANTS` (the CTA
   tile in warps, the warp tile in m16 tiles, CTAs per SM asked of
   ptxas; the other order of the tiles or plain stores; or a cut that
   leaves out some of the kernel's phases, to see what each costs; or the
   popcount identity of `scripts/hamming_popcount_identity.cu` spliced in
   for the kernel) into
   the git-ignored `arroy_tpu_torch/_build/`, holds each uncut variant
   bit-equal to the plain version at edge shapes, and times each at the
   main path's shape (B=2048, M=100,000, w=24; CUDA events, mean of 20
   launches after warm-up).
3. Times two yardsticks at that shape: filling the [B, M] int32 output
   (`Tensor.fill_`: the write alone) and `torch._int_mm` on the ±1 int8
   operands (the same product through cuBLAS).

Run from the repository root on a machine with a card:

    python3 scripts/torch_hamming_tune.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from arroy_tpu_torch.ops import _build, bq_kernels as bk  # noqa: E402
from arroy_tpu_torch.ops.binary import unpack_bits  # noqa: E402
from chip_smoke import HBM_BPS, cuda_ms  # noqa: E402

#: the settings of hamming.cu that a variant may change, as the source has them
SETTINGS = {"kWarpsQ": "2", "kWarpsX": "4", "kMT": "4", "kMinBlocks": "2"}
#: choices the source made, and the alternative each was chosen over
#: (bit-equal, so checked): the tile order and the stores' cache hint
ALTERNATIVES = {
    "corpus tiles fastest": (("{ return t % nq; }", "{ return t / nx; }"),
                             ("{ return t / nq; }", "{ return t % nx; }")),
    "plain stores": (("st.global.cs.v4.s32", "st.global.v4.s32"),),
}
#: diagnostic cuts of the source (not bit-equal, so not checked): the
#: kernel without some of its phases (staging, MMAs, output stores, the
#: barrier between tiles)
_NO_STORES = (("if (whole) {", "if (d[0] == INT_MIN) {"), ("} else if (b < B) {", "} else if (false) {"))
_NO_STAGING = (("  start(0);", "  "), ("if (s + 1 < n_stages) start(s + 1);", ""))
_NO_MMAS = (("for (int ks = 0; ks < kc; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),)
#: the other identity's kernel, spliced in for hamming.cu's own, and the
#: room its two sets of row popcounts take
IDENTITY_KERNEL = "hamming_popcount_identity.cu"
_KERNEL_START = "__global__ void __launch_bounds__"
_KERNEL_END = "}  // namespace"
_SMEM = ("(size_t)2 * kRows * stride * sizeof(uint32_t)",
         "(size_t)2 * kRows * (stride + 1) * sizeof(uint32_t)")
CUTS = {
    "no stores": _NO_STORES,
    "stores only": _NO_STAGING + _NO_MMAS,
    "no stores, no MMAs": _NO_STORES + _NO_MMAS,
    "MMAs only": _NO_STORES + _NO_STAGING + (("    __syncthreads();\n", ""),),
}
#: variants: the settings changed from the source's, and a cut
VARIANTS = (
    {},
    {"alt": "corpus tiles fastest"},
    {"alt": "plain stores"},
    {"kMinBlocks": "3"},
    {"kWarpsQ": "1", "kWarpsX": "8"},
    {"kWarpsX": "8", "kMinBlocks": "1"},
    {"kWarpsQ": "4", "kMinBlocks": "1"},
    {"kWarpsQ": "4", "kMT": "2"},
    {"kWarpsQ": "4", "kMT": "2", "kWarpsX": "2", "kMinBlocks": "4"},
    {"kernel": IDENTITY_KERNEL},
    {"cut": "no stores"},
    {"cut": "stores only"},
    {"cut": "no stores, no MMAs"},
    {"cut": "MMAs only"},
)
PARITY = ((130, 1537, 24), (1, 127, 9), (65, 100_000, 24), (130, 1537, 40), (65, 700, 320))
MAIN = (2048, 100_000, 24)


def nvcc(src: str, so: str) -> str:
    """Compile `src` into `so`; returns ptxas's register / spill lines."""
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return " | ".join(line.split("ptxas info    :")[-1].strip()
                      for line in (proc.stdout + proc.stderr).splitlines()
                      if "registers" in line or "spill" in line)


def label(variant) -> str:
    v = {**SETTINGS, **variant}
    return (f"tile {int(v['kWarpsQ']) * 16 * int(v['kMT'])}x{int(v['kWarpsX']) * 32} "
            f"(warps of {16 * int(v['kMT'])}x32, {v['kMinBlocks']} CTAs/SM for ptxas)"
            + "".join(f" [{v[k]}]" for k in ("alt", "cut") if k in v)
            + (" [popcount identity]" if "kernel" in v else ""))


def build_variant(variant) -> tuple[ctypes.CDLL, str]:
    with open(os.path.join(_build.CSRC_DIR, "hamming.cu")) as f:
        text = f.read()
    for name, value in SETTINGS.items():
        line = f" {name} = {value};"
        assert line in text, f"hamming.cu no longer holds {line!r}"
        text = text.replace(line, f" {name} = {variant.get(name, value)};")
    if "kernel" in variant:
        with open(os.path.join(HERE, variant["kernel"])) as f:
            kernel = f.read()
        assert text.count(_KERNEL_START) == 1 and text.count(_KERNEL_END) == 1
        assert text.count(_SMEM[0]) == 1, "hamming.cu's shared-memory size moved"
        text = (text[:text.index(_KERNEL_START)] + kernel
                + text[text.index(_KERNEL_END):]).replace(*_SMEM)
    for old, new in ALTERNATIVES.get(variant.get("alt"), ()) + CUTS.get(variant.get("cut"), ()):
        assert text.count(old) == 1, f"hamming.cu does not hold {old!r} once"
        text = text.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in str(sorted(variant.items()))) or "default"
    src = os.path.join(_build.BUILD_DIR, f"hamming_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    info = nvcc(src, os.path.join(_build.BUILD_DIR, f"libhamming_{tag}.so"))
    lib = ctypes.CDLL(os.path.join(_build.BUILD_DIR, f"libhamming_{tag}.so"))
    lib.bq_hamming.restype = ctypes.c_int
    lib.bq_hamming.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, info


def words(rng, n, w, dev, offset=0):
    """[n, w] random int32 words; with an offset, a contiguous view that
    starts `offset` words into its storage (not 16-byte aligned)."""
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (n * w + offset,), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    return a[offset:].view(n, w)


def mma_rates(dev) -> None:
    src = os.path.join(HERE, "mma_rate.cu")
    so = os.path.join(_build.BUILD_DIR, "libmma_rate.so")
    nvcc(src, so)
    lib = ctypes.CDLL(so)
    lib.mma_rate.restype = ctypes.c_int
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 8192
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    n_mma = blocks * threads // 32 * iters * lib.mma_chains()
    for op, name, per in ((0, "b1 m16n8k256 .and.popc", 256 * 16 * 8), (1, "s8 m16n8k32", 32 * 16 * 8)):
        def run():
            _build.check(lib.mma_rate(op, blocks, threads, iters, out.data_ptr(), stream), name)
        ms = cuda_ms(run, 5)
        print(f"mma {name}: {n_mma / sms / (ms * 1e3):.2f} MMAs per SM per us, "
              f"{2.0 * per * n_mma / (ms / 1e3) / 1e12:.1f} TOP/s ({ms:.3f} ms for {n_mma} MMAs)",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_hamming_tune: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    mma_rates(dev)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    rng = np.random.default_rng(0)
    cases = [(words(rng, b, w, dev), words(rng, m, w, dev)) for b, m, w in PARITY]
    cases.append((words(rng, 130, 24, dev, 1), words(rng, 1537, 24, dev, 3)))
    b, m, w = MAIN
    qw, xw = words(rng, b, w, dev), words(rng, m, w, dev)
    want = bk.bq_hamming_matrix_reference(qw, xw)
    failed = False
    for variant, (lib, info) in built:
        bk._lib = lambda lib=lib: lib
        bad = []
        for (q, x), shape in [] if "cut" in variant else zip(cases + [(qw, xw)], PARITY + ((130, 1537, "24 unaligned"), MAIN)):
            got = bk.bq_hamming_matrix(q, x)
            ref = want if shape == MAIN else bk.bq_hamming_matrix_reference(q, x)
            if not torch.equal(got, ref):
                diff = (got != ref).nonzero()[:4].tolist()
                bad.append(f"{shape}: {int((got != ref).sum())} differ, first {diff} "
                           f"got {[int(got[i, j]) for i, j in diff]} want {[int(ref[i, j]) for i, j in diff]}")
        ms = cuda_ms(lambda: bk.bq_hamming_matrix(qw, xw), 20)
        gbs = 4.0 * b * m / (ms / 1e3) / 1e9
        print(f"{label(variant)}: {ms:.4f} ms, {gbs:.0f} GB/s of output, {'not checked' if 'cut' in variant else 'bit-equal' if not bad else 'DIFFERS'}; {info}",
              flush=True)
        for line in bad:
            print("  " + line, flush=True)
        failed |= bool(bad)

    out = torch.empty((b, m), dtype=torch.int32, device=dev)
    fill_ms = cuda_ms(lambda: out.fill_(7), 20)
    qb = unpack_bits(qw, 32 * w).to(torch.int8)
    xb = unpack_bits(xw, 32 * w).to(torch.int8)
    dot = torch._int_mm(qb, xb.t())
    assert torch.equal(dot, 32 * w - 2 * want), "±1 dot differs from the counts"
    gemm_ms = cuda_ms(lambda: torch._int_mm(qb, xb.t()), 20)
    bound_ms = 4.0 * (qw.numel() + xw.numel() + b * m) / HBM_BPS * 1e3
    print(f"at B={b} M={m} w={w}: bound {bound_ms:.4f} ms (bytes), fill_ of the output "
          f"{fill_ms:.4f} ms ({4.0 * b * m / (fill_ms / 1e3) / 1e9:.0f} GB/s), "
          f"torch._int_mm on ±1 int8 {gemm_ms:.4f} ms", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
