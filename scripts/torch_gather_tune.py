#!/usr/bin/env python3
"""Kernel 3 (`arroy_tpu_torch/csrc/gather_score.cu`): what bounds it, by
cutting phases out of copies of the source and timing each.

1. Builds the probe slice of `chip_smoke.py` phase 6 (262,144 x 768
   clustered corpus, seed 42, euclidean, 10 trees) and takes, for each
   table type, the [B, C] block ids that stage 1 selects for the first
   batch of 256 queries (bf16 and int8 at search_k 4000, C = 72; f32 at
   2000, C = 36), with the query as the probe sends it.
2. Builds a copy of `gather_score.cu` for each entry of `VARIANTS` into
   the git-ignored `arroy_tpu_torch/_build/` (one nvcc each, all
   started together): the shipped source; int8 by I2F (the conversion it
   replaced); CTAs of 8, 2 or 1 warps (the shipped ones have 4); twice
   and half the rows a warp holds (8 int8, 4 bf16, 2 f32); 6 CTAs an SM
   asked of ptxas (at most 80 registers); a warp sum per
   row (5 shuffles a row) in place of the transposed sums; and diagnostic
   cuts, not held to the plain version: the row loads alone, and the
   loads with the conversion but no query (an add in place of each FMA).
3. Times each copy on each table type (CUDA events, mean of 20 calls after
   warm-up, as the calls come from the host and on the device alone, with
   the host's queueing hidden behind a spin kernel) with the block schedule (the pairs sorted by block, as
   the wrapper runs them) and without it (the pairs in query order, so
   each pair reads its block); int8 also with 16-byte loads, which leave
   half the lanes idle for a third of a row.  Each uncut copy is held to
   the plain version within 1e-5 * sum|row*q|.
4. Times the schedule kernel alone (and `torch.sort` of the same ids,
   the torch-op schedule it replaced), and the probe's own chunked calls
   (stage 2 splits C into chunks of `probe.gather_chunk` blocks) with and
   without the schedule.
5. With ``--baseline PATH``, also times the kernel in PATH, a source with
   the interface before the block schedule (rows, bid, q, out, B, C, P,
   d, nbt, stream: no scratch argument), in turns with the shipped
   one: baseline, shipped, shipped, baseline.

Run from the repository root on a machine with a card:

    python3 scripts/torch_gather_tune.py [--baseline PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from arroy_tpu_torch.ops import _build, gather_score as gs  # noqa: E402
from arroy_tpu_torch.probe import gather_chunk  # noqa: E402
from chip_smoke import HBM_BPS, cuda_ms, device_ms, make_corpus  # noqa: E402

D, M_PROBE, B, N_TREES = 768, 262_144, 256, 10
#: table type -> search_k of chip_smoke phase 6's served searcher
SEARCH_K = {"bf16": 4000, "int8": 4000, "f32": 2000}
_FMA = "acc[i] = fmaf(elem<T>(w[i][j][e / EW], e % EW), qv[e], acc[i]);"
_LOAD_Q = "load_q<VE>(qb + static_cast<size_t>(v) * VE, qv);"
_I2F = (("return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + k)) - 8388736.0f;",
         "return static_cast<float>(static_cast<signed char>(w >> (8 * k)));"),
        ("constexpr unsigned flip = sizeof(T) == 1 ? 0x80808080u : 0u;",
         "constexpr unsigned flip = 0u;"))
_NO_Q = ((_LOAD_Q, ""),)
_ROWS = ("struct Rows<float> { static constexpr int value = 2; }",
         "struct Rows<unsigned short> { static constexpr int value = 4; }",
         "struct Rows<signed char> { static constexpr int value = 8; }")


def _rows_times(f: float):
    """Substitutions that scale the rows a warp holds (and its registers) by f."""
    subs = tuple((r, r.replace(f"value = {v};", f"value = {int(v * f)};"))
                 for r, v in zip(_ROWS, (2, 4, 8)))
    return subs + (("kLaneRegs = 48;", f"kLaneRegs = {int(48 * f)};"),)


#: variant -> (substitutions, held to the plain version)
VARIANTS = {
    "shipped": ((), True),
    "int8 by I2F": (_I2F, True),
    "loads + conversion, no query (add for FMA)": (
        _NO_Q + ((_FMA, "acc[i] += elem<T>(w[i][j][e / EW], e % EW);"),), False),
    "8 warps a CTA": ((("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),), True),
    "2 warps a CTA": ((("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),), True),
    "1 warp a CTA": ((("constexpr int kWarps = 4;", "constexpr int kWarps = 1;"),), True),
    "6 CTAs an SM for ptxas": ((("__launch_bounds__(kWarps * 32)",
                                  "__launch_bounds__(kWarps * 32, 6)"),), True),
    "twice the rows a warp": (_rows_times(2), True),
    "half the rows a warp": (_rows_times(0.5), True),
    "a warp sum per row": ((("const float sum = row_sums<R>(acc, lane);",
                             "float sum = 0.f; for (int i = 0; i < R; ++i) { float t = acc[i]; "
                             "for (int o = 16; o > 0; o /= 2) t += __shfl_xor_sync(0xffffffffu, t, o); "
                             "if (lane / (32 / R) == i) sum = t; }"),), True),
    "loads only": (_NO_Q + ((_FMA, "if (e == 0) { unsigned x = 0; for (int k = 0; k < NW; ++k) "
                                   "x ^= w[i][j][k]; acc[i] += __uint_as_float(x & 0x3fffffffu); }"),),
                   False),
}


def nvcc(src: str, so: str) -> str:
    """Compile `src` into `so`; returns ptxas's register / spill lines."""
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return " | ".join(line.split("ptxas info    :")[-1].strip()
                      for line in (proc.stdout + proc.stderr).splitlines()
                      if "registers" in line or "spill" in line)


def build(tag: str, text: str, nargs: int) -> tuple[ctypes.CDLL, str]:
    src = os.path.join(_build.BUILD_DIR, f"gather_score_{tag}.cu")
    so = os.path.join(_build.BUILD_DIR, f"libgather_score_{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    info = nvcc(src, so)
    lib = ctypes.CDLL(so)
    lib.gather_score.restype = ctypes.c_int
    # rows, bid, q, out; B, C, P, d, nbt; the stream (and the schedule's scratch)
    lib.gather_score.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * (nargs - 11))
    return lib, info


def build_variant(name: str) -> tuple[ctypes.CDLL, str]:
    with open(os.path.join(_build.CSRC_DIR, "gather_score.cu")) as f:
        text = f.read()
    for old, new in VARIANTS[name][0]:
        assert text.count(old) == 1, f"gather_score.cu does not hold {old!r} once"
        text = text.replace(old, new)
    return build("".join(c if c.isalnum() else "_" for c in name), text, 13)


def selections(dev):
    """Table type -> (rows, bid [B, C] int32, q [B, d] f32) of the slice."""
    from arroy_tpu_torch import Database, Reader, Writer

    rng = np.random.default_rng(42)
    x = make_corpus(rng, M_PROBE + B, D)
    x, queries = x[:M_PROBE], x[M_PROBE:]
    db = Database(None, device=dev)
    w = Writer(db, 0, D, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(M_PROBE, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    out = {}
    for kind, dtype in (("bf16", "auto"), ("int8", "int8"), ("f32", "f32")):
        t0 = time.perf_counter()
        s = r.searcher(10, search_k=SEARCH_K[kind], engine="forest", probe_dtype=dtype)
        fn = s.device_fn
        qv = s.prepare_queries(queries)[0]
        bid = fn.block_ids(qv).to(torch.int32).contiguous()
        q = (qv if kind == "f32" else qv.to(torch.bfloat16).float()).contiguous()
        out[kind] = (fn.tables.blk_rows, bid, q)
        print(f"{kind}: tables {tuple(fn.tables.blk_rows.shape)} in {time.perf_counter() - t0:.1f} s, "
              f"bid {tuple(bid.shape)}, {int(torch.unique(bid).numel())} distinct blocks", flush=True)
    return out


def runner(lib, rows, bid, q, schedule: bool, vb: int | None = None):
    """A call of `lib`'s kernel with or without the block schedule (the sort
    is inside the call, as in the wrapper)."""
    row_type, _ = gs._ROW_TYPES[rows.dtype]
    vb = vb or gs._vec_bytes(rows)
    nbt, p, d = rows.shape
    b, c = bid.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((b, c, p), dtype=torch.float32, device=rows.device)
        scratch = torch.empty(2 * b * c + nbt + 1, dtype=torch.int32, device=rows.device)
        _build.check(lib.gather_score(row_type, vb, rows.data_ptr(), bid.data_ptr(), q.data_ptr(),
                                      out.data_ptr(), b, c, p, d, nbt, stream,
                                      scratch.data_ptr() if schedule else None), "variant")
        return out

    return run


def within(got, rows, bid, q) -> float:
    """Max |got - plain| / (1e-5 sum|row*q|): at most 1 is within tolerance."""
    want = gs.gather_score_reference(rows, bid, q)
    worst = 0.0
    for s in range(0, bid.shape[1], 4):
        sl = bid[:, s:s + 4].long()
        mag = 1e-5 * torch.einsum("bcpd,bd->bcp", rows[sl].float().abs(), q.abs())
        err = (got[:, s:s + 4] - want[:, s:s + 4]).abs()
        worst = max(worst, float((err / mag.clamp_min(1e-30)).max()))
    return worst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older gather_score.cu, whose entry point takes no scratch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_tune: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        if args.baseline:
            with open(args.baseline) as f:
                base_job = ex.submit(build, "baseline", f.read(), 12)
        built = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
        base = base_job.result() if args.baseline else None
    for name, (_, info) in built.items():
        print(f"built {name}: {info}", flush=True)
    sel = selections(dev)

    failed = False
    for kind, (rows, bid, q) in sel.items():
        b, c = bid.shape
        _, p, d = rows.shape
        blk = p * d * rows.element_size()
        uniq = int(torch.unique(bid).numel())
        keys, _ = gs.block_schedule(bid, rows.shape[0])
        reads = gs.block_reads(keys)
        bound_ms = (uniq * blk + 4 * (b * c * p + b * d + b * c)) / HBM_BPS * 1e3
        print(f"\n{kind} at B={b} C={c} P={p} d={d}: {uniq} distinct blocks of {b * c} pairs, "
              f"the kernel reads {reads}; bytes bound {bound_ms:.4f} ms; load width "
              f"{gs._vec_bytes(rows)} B", flush=True)
        cases = [(name, sched, None) for name in VARIANTS for sched in (True, False)]
        if kind == "int8":
            cases += [("shipped", True, 16), ("shipped", False, 16)]
        for name, sched, vb in cases:
            if kind != "int8" and name == "int8 by I2F":
                continue
            run = runner(built[name][0], rows, bid, q, sched, vb)
            tol = ""
            if VARIANTS[name][1]:
                worst = within(run(), rows, bid, q)
                failed |= worst > 1
                tol = f", {worst:.3f} of the tolerance"
            ms = cuda_ms(run, 20)
            dms = device_ms(run, 20)
            nread = reads if sched else b * c
            print(f"  {name}{' [16-byte loads]' if vb else ''}, "
                  f"{'schedule' if sched else 'query order'}: {ms:.4f} ms ({dms:.4f} on the "
                  f"device alone), "
                  f"{nread * blk / dms / 1e6:.0f} GB/s of blocks read, "
                  f"{bound_ms / dms:.3f} of the bound{tol}", flush=True)
        ch = gather_chunk(b, rows)
        chunks = [bid[:, i:i + ch].contiguous() for i in range(0, c, ch)]
        sched_ms = device_ms(lambda: gs.block_schedule(bid, rows.shape[0]), 20)
        sched_ch_ms = device_ms(lambda: gs.block_schedule(chunks[0], rows.shape[0]), 20)
        sort_ms = device_ms(lambda: torch.sort(bid.reshape(-1)), 20)
        lib = built["shipped"][0]
        for sched in (True, False):
            runs = [runner(lib, rows, x, q, sched) for x in chunks]
            ms = cuda_ms(lambda: [r() for r in runs], 20)
            dms = device_ms(lambda: [r() for r in runs], 20)
            nread = sum(gs.block_reads(gs.block_schedule(x, rows.shape[0])[0]) if sched
                        else x.numel() for x in chunks)
            print(f"  probe's {len(chunks)} chunks of {ch}, {'schedule' if sched else 'query order'}: "
                  f"{ms:.4f} ms in all ({dms:.4f} on the device alone), {nread} blocks read",
                  flush=True)
        print(f"  on the device alone: the schedule kernel {sched_ms:.4f} ms ({sched_ch_ms:.4f} "
              f"for one chunk); torch.sort of the {b * c} ids {sort_ms:.4f} ms", flush=True)
        if args.baseline:
            lib_b = base[0]
            out = torch.empty((b, c, p), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            row_type, _ = gs._ROW_TYPES[rows.dtype]
            es = rows.element_size()
            vb_old = next(v for v in (16, 8, 4, 2, 1) if v >= es and (d * es) % v == 0)

            def old():
                _build.check(lib_b.gather_score(row_type, vb_old, rows.data_ptr(), bid.data_ptr(),
                                                q.data_ptr(), out.data_ptr(), b, c, p, d, rows.shape[0],
                                                stream), "baseline")

            new = runner(built["shipped"][0], rows, bid, q, True)
            times = [cuda_ms(f, 20) for f in (old, new, new, old)]
            dtimes = [device_ms(f, 20) for f in (old, new, new, old)]
            print(f"  baseline, shipped, shipped, baseline: "
                  + ", ".join(f"{t:.4f}" for t in times) + " ms ("
                  + ", ".join(f"{t:.4f}" for t in dtimes) + " on the device alone)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
