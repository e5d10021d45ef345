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
4. Times the schedule kernels alone (and `torch.sort` of the same ids,
   the torch-op schedule it replaced), and the JAX package's chunks of C
   (`probe.gather_chunk`'s rule off the card, which the probe took on the
   card before the kernel wrote the scores) with and without the schedule.
5. With ``--baseline PATH``, also times the kernel in PATH, a source with
   the interface before the epilogue (rows, bid, q, out, B, C, P, d, nbt,
   stream, scratch of 2·B·C + nbt + 1 int32: `git show
   <commit>:arroy_tpu_torch/csrc/gather_score.cu` of an older commit), in
   turns with the shipped one: baseline, shipped, shipped, baseline.

With ``--cell WORKLOAD --seed N`` it runs none of the above: it builds the
benchmark cell as ``benchmark/run.py`` does (the probe cell,
``glove100-probe-b2048``: 1,183,514 x 100 cosine, 8 probe trees of 64-slot
bf16 blocks, B 2048, search_k 8000) and times its stage 2 on the [B, T·L]
selection stage 1 makes for the first batch: the one pass the probe runs
(kernel 3 with its epilogue, `torch.topk`, the winners' slots) against the
parent's chain of 16 chunks (the JAX package's chunks: the dots, the
epilogue as PyTorch ops, a cut a chunk, one merge), on the shipped
kernel's dots (its "dot" op, every slot live) and, with ``--baseline``, on
the baseline's (its own schedule), in turns: chain, one pass, one pass,
chain; plus the schedule alone, the kernel alone, and the blocks read by
one schedule and by 16.

With ``--crossover`` it measures `ops.gather_score.SCHEDULE_MIN_BYTES`
instead: kernel 3 with the probe's epilogue, the pairs sorted by block
against the pairs in query order, on the first B queries (each B of
`CROSSOVER_B` the selection holds) of the slice's three selections
(step 1) and, with ``--cell``, of the cell's first batch; the device time
of each way in turns (query order, sorted, sorted, query order), the
schedule alone, and the blocks each way reads, a JSON line a shape.

Run from the repository root on a machine with a card:

    python3 scripts/torch_gather_tune.py [--baseline PATH]
    python3 scripts/torch_gather_tune.py --cell glove100-probe-b2048 --seed N [--baseline PATH]
    python3 scripts/torch_gather_tune.py --crossover [--cell glove100-probe-b2048 --seed N]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from arroy_tpu_torch import probe  # noqa: E402
from arroy_tpu_torch.ops import _build, gather_score as gs  # noqa: E402
from arroy_tpu_torch.probe import gather_chunk  # noqa: E402
from chip_smoke import (HBM_BPS, cuda_ms, device_ms, dots_epilogue, make_corpus,  # noqa: E402
                        stage2_forms)

D, M_PROBE, B, N_TREES = 768, 262_144, 256, 10
#: queries of the selections' heads that `--crossover` times
CROSSOVER_B = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
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
    # rows, bid, q, out; B, C, P, d, nbt; the stream, the schedule's scratch
    # (and the epilogue: op, aux, slots, scale, fmask)
    lib.gather_score.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                                 + ([ctypes.c_int] + [ctypes.c_void_p] * 4) * (nargs == 18))
    return lib, info


def build_variant(name: str) -> tuple[ctypes.CDLL, str]:
    with open(os.path.join(_build.CSRC_DIR, "gather_score.cu")) as f:
        text = f.read()
    for old, new in VARIANTS[name][0]:
        assert text.count(old) == 1, f"gather_score.cu does not hold {old!r} once"
        text = text.replace(old, new)
    return build("".join(c if c.isalnum() else "_" for c in name), text, 18)


def selections(dev):
    """Table type -> (rows, bid [B, C] int32, q [B, d] f32, the probe's
    euclidean epilogue) of the slice."""
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
        t = fn.tables
        out[kind] = (t.blk_rows, bid, q, gs.Epilogue("euclidean", t.blk_aux, t.blk_slots,
                                                     t.blk_scale if kind == "int8" else None))
        print(f"{kind}: tables {tuple(fn.tables.blk_rows.shape)} in {time.perf_counter() - t0:.1f} s, "
              f"bid {tuple(bid.shape)}, {int(torch.unique(bid).numel())} distinct blocks", flush=True)
    return out


def runner(lib, rows, bid, q, schedule: bool, vb: int | None = None):
    """A call of `lib`'s kernel writing the dots ("dot" op, every slot
    live) with or without the block schedule (the sort is inside the call,
    as in the wrapper)."""
    row_type, _ = gs._ROW_TYPES[rows.dtype]
    vb = vb or gs._vec_bytes(rows)
    nbt, p, d = rows.shape
    b, c = bid.shape
    stream = torch.cuda.current_stream().cuda_stream
    ep = gs._epilogue_args(dots_epilogue(gs, rows), nbt, p, rows.device)

    def run():
        out = torch.empty((b, c, p), dtype=torch.float32, device=rows.device)
        scratch = torch.empty(gs.schedule_words(b * c, nbt), dtype=torch.int32, device=rows.device)
        _build.check(lib.gather_score(row_type, vb, rows.data_ptr(), bid.data_ptr(), q.data_ptr(),
                                      out.data_ptr(), b, c, p, d, nbt, stream,
                                      scratch.data_ptr() if schedule else None, *ep), "variant")
        return out

    return run


def baseline_runner(lib, rows, bid, q):
    """A call of a baseline kernel (the interface before the epilogue:
    scratch of 2·B·C + nbt + 1 int32 for its own schedule), writing dots."""
    row_type, _ = gs._ROW_TYPES[rows.dtype]
    nbt, p, d = rows.shape
    b, c = bid.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((b, c, p), dtype=torch.float32, device=rows.device)
        scratch = torch.empty(2 * b * c + nbt + 1, dtype=torch.int32, device=rows.device)
        _build.check(lib.gather_score(row_type, gs._vec_bytes(rows), rows.data_ptr(),
                                      bid.data_ptr(), q.data_ptr(), out.data_ptr(), b, c, p, d,
                                      nbt, stream, scratch.data_ptr()), "baseline")
        return out

    return run


def cell_selection(args):
    """The benchmark cell `args.cell` built as ``benchmark/run.py`` builds
    it at `args.seed`: (rows, bid [B, C] int32 of its first batch, q [B, d]
    f32 as the probe sends it, the probe's epilogue, its device_fn)."""
    from benchmark import cell as cell_mod, data, spec

    c = spec.load_cell(args.cell)
    cfg, traffic = c.config, c.traffic
    t0 = time.perf_counter()
    x, pool = data.vectors(cfg, args.seed, "cuda")
    batch = np.ascontiguousarray(pool[data.schedule(len(pool), traffic["batch"], args.seed)[0]])
    _, reader = cell_mod._build(cfg, x, args.seed, "cuda")
    s = reader.searcher(cfg["k"], **traffic["searcher"])
    fn = s.device_fn
    assert s.route == "probe", f"{args.cell} does not serve the probe"
    t = fn.tables
    rows = t.blk_rows
    qv = s.prepare_queries(batch)[0]
    bid = fn.block_ids(qv).to(torch.int32).contiguous()
    q = (qv if rows.dtype == torch.float32 else qv.to(torch.bfloat16).float()).contiguous()
    ep = gs.Epilogue(probe.score_op(reader.metric.name), t.blk_aux, t.blk_slots,
                     t.blk_scale if rows.dtype == torch.int8 else None)
    print(f"{args.cell} seed {args.seed}: set up in {time.perf_counter() - t0:.1f} s; tables "
          f"{tuple(rows.shape)} {rows.dtype}, B {bid.shape[0]}, C = T·L = {t.n_trees}·{fn.L} = "
          f"{bid.shape[1]}, k2 {fn.k2}", flush=True)
    return rows, bid, q, ep, fn


def cell_stage2(args, dev) -> int:
    """The probe cell's stage 2, one pass against the parent's 16-chunk
    chain (module docstring)."""
    rows, bid, q, ep, fn = cell_selection(args)
    P = rows.shape[1]
    b, C = bid.shape
    nbt = rows.shape[0]
    k2 = fn.k2
    dots = dots_epilogue(gs, rows)
    dot_fns = {"shipped": None}
    if args.baseline:
        with open(args.baseline) as f:
            lib_b, info = build("baseline", f.read(), 13)
        print(f"built baseline: {info}", flush=True)
        dot_fns["baseline"] = lambda x: baseline_runner(lib_b, rows, x, q)()
    forms = {k: stage2_forms(gs, rows, bid, q, ep, k2, f) for k, f in dot_fns.items()}
    one_pass, _, chunks = forms["shipped"]
    nch, ch = len(chunks), chunks[0].shape[1]
    chain = {k: f[1] for k, f in forms.items()}

    want = one_pass()
    same = {k: bool(torch.equal(f()[0], want[0])) for k, f in chain.items()}
    keys, _ = gs.block_schedule(bid, nbt)
    reads = gs.block_reads(keys)
    reads_ch = sum(gs.block_reads(gs.block_schedule(x, nbt)[0]) for x in chunks)
    uniq = int(torch.unique(bid).numel())
    blk = P * rows.shape[2] * rows.element_size()
    nbytes = uniq * (blk + 8 * P) + 4 * b * (C + rows.shape[2] + C * P)
    out = {"cell": args.cell, "seed": args.seed, "B": b, "C": C, "chunks": nch, "chunk_blocks": ch,
           "k2": k2, "distinct_blocks": uniq, "reads_one_schedule": reads,
           "reads_chunked_schedules": reads_ch, "bound_ms": nbytes / HBM_BPS * 1e3,
           "same_top_k2_scores": same,
           "schedule_ms": device_ms(lambda: gs.block_schedule(bid, nbt), 20),
           "schedule_chunk_ms": device_ms(lambda: gs.block_schedule(chunks[0], nbt), 20),
           "kernel_ms": device_ms(lambda: gs.gather_score(rows, bid, q, ep), 20),
           "dots_kernel_ms": device_ms(lambda: gs.gather_score(rows, bid, q, dots), 20)}
    turns = {}
    for kernel, run_chain in chain.items():
        for name, f in ((f"chain_{kernel}", run_chain), ("one_pass", one_pass),
                        ("one_pass", one_pass), (f"chain_{kernel}", run_chain)):
            reps = 5 if name == "one_pass" else 3
            turns.setdefault(name, []).append((device_ms(f, reps), cuda_ms(f, reps)))
    out["turns_device_wall_ms"] = turns
    print(json.dumps(out), flush=True)
    return 0 if all(same.values()) else 1


def crossover(args, dev) -> int:
    """Where sorting the pairs by block pays (module docstring)."""
    shapes = {f"slice {kind}": v for kind, v in selections(dev).items()}
    if args.cell:
        shapes[args.cell] = cell_selection(args)[:4]
    min_bytes = gs.SCHEDULE_MIN_BYTES

    def timed(rows, bid, q, ep, sort: bool) -> float:
        gs.SCHEDULE_MIN_BYTES = 0 if sort else 2**62
        return device_ms(lambda: gs.gather_score(rows, bid, q, ep), 20)

    try:
        for name, (rows, bid, q, ep) in shapes.items():
            nbt, p, d = rows.shape
            for b in (b for b in CROSSOVER_B if b <= bid.shape[0]):
                x, qb = bid[:b].contiguous(), q[:b].contiguous()
                turns = [timed(rows, x, qb, ep, sort) for sort in (False, True, True, False)]
                query_ms, sorted_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                print(json.dumps({
                    "shape": name, "dtype": str(rows.dtype).removeprefix("torch."), "nbt": nbt,
                    "P": p, "d": d, "B": b, "C": x.shape[1],
                    "gather_bytes": x.numel() * p * d * rows.element_size(),
                    "distinct_blocks": int(torch.unique(x[x >= 0]).numel()),
                    "reads_sorted": gs.block_reads(gs.block_schedule(x, nbt)[0]),
                    "query_order_ms": query_ms, "sorted_ms": sorted_ms,
                    "sorted_over_query_order": sorted_ms / query_ms, "turns_ms": turns,
                    "schedule_ms": device_ms(lambda: gs.block_schedule(x, nbt), 20)}), flush=True)
    finally:
        gs.SCHEDULE_MIN_BYTES = min_bytes
    return 0


def within(got, rows, bid, q) -> float:
    """Max |got - plain| / (1e-5 sum|row*q|) over dots: at most 1 is within
    tolerance."""
    want = gs.gather_score_reference(rows, bid, q, dots_epilogue(gs, rows))
    worst = 0.0
    for s in range(0, bid.shape[1], 4):
        sl = bid[:, s:s + 4].long()
        mag = 1e-5 * torch.einsum("bcpd,bd->bcp", rows[sl].float().abs(), q.abs())
        err = (got[:, s:s + 4] - want[:, s:s + 4]).abs()
        worst = max(worst, float((err / mag.clamp_min(1e-30)).max()))
    return worst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older gather_score.cu, whose entry point takes the "
                    "schedule's scratch and no epilogue")
    ap.add_argument("--cell", help="time a benchmark cell's stage 2 (the probe cell) instead")
    ap.add_argument("--seed", type=int, default=1, help="the cell's seed (with --cell)")
    ap.add_argument("--crossover", action="store_true",
                    help="time the block schedule against query order (SCHEDULE_MIN_BYTES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_tune: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    if args.crossover:
        return crossover(args, dev)
    if args.cell:
        return cell_stage2(args, dev)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        if args.baseline:
            with open(args.baseline) as f:
                base_job = ex.submit(build, "baseline", f.read(), 13)
        built = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
        base = base_job.result() if args.baseline else None
    for name, (_, info) in built.items():
        print(f"built {name}: {info}", flush=True)
    sel = selections(dev)

    failed = False
    for kind, (rows, bid, q, _) in sel.items():
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
        ch = gather_chunk(b, rows, False)
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
            print(f"  the JAX package's {len(chunks)} chunks of {ch}, "
                  f"{'schedule' if sched else 'query order'}: "
                  f"{ms:.4f} ms in all ({dms:.4f} on the device alone), {nread} blocks read",
                  flush=True)
        print(f"  on the device alone: the schedule kernels {sched_ms:.4f} ms ({sched_ch_ms:.4f} "
              f"for one chunk); torch.sort of the {b * c} ids {sort_ms:.4f} ms", flush=True)
        if args.baseline:
            lib_b = base[0]
            old = baseline_runner(lib_b, rows, bid, q)
            new = runner(built["shipped"][0], rows, bid, q, True)
            times = [cuda_ms(f, 20) for f in (old, new, new, old)]
            dtimes = [device_ms(f, 20) for f in (old, new, new, old)]
            print(f"  baseline, shipped, shipped, baseline: "
                  + ", ".join(f"{t:.4f}" for t in times) + " ms ("
                  + ", ".join(f"{t:.4f}" for t in dtimes) + " on the device alone)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
