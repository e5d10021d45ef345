#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`arroy_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and the script
exits non-zero:

1. device — requires CUDA (never runs on the CPU); prints the card's name
   and power limit as nvidia-smi reports them;
2. build — compiles the hand-written kernels from `arroy_tpu_torch/csrc/`,
   one nvcc per source, all started together, and counts tensor-core
   instructions in their SASS with cuobjdump: kernel 1's two instances
   (wgmma) and kernel 2 (one-bit mma.sync) must have some;
3. kernel parity — each kernel against its plain PyTorch version on the
   card, at edge-straddling shapes and at the main path's shapes, where
   both are timed with CUDA events beside the card's bound for the same
   work and, where one exists, a PyTorch library call computing it
   (kernels 1 and 2 also beside cuBLAS's bare GEMM at the same shape);
4. slice — the bench configuration (100,000 x 768 clustered corpus,
   euclidean, 10 trees): add, build, commit to disk, reopen, validate,
   then exact search at f32x1 / bf16 / int8 on 4 batches of 2048
   queries, with recall and brute-force checks;
5. BQ slice — the same corpus under "binary quantized cosine", checked
   tie-aware against the same engine run on the CPU (plain versions);
6. probe slice — 262,144 x 768 (the size at which the forest engine's
   ``traversal="auto"`` serves the leaf-probe engine), euclidean, 10
   trees, 8 batches of 256 queries: ``searcher(engine="forest")`` must
   resolve to the probe; bench.py's search_k policy (start at 2000,
   double until recall@10 against f32x1 reaches 0.95) for bf16, int8 and
   f32 block tables; 64 queries held against the same searcher on the
   CPU; the default (bf16) probe at search_k 4000 and 8000 with the JAX
   package's re-score cut (512) and the port's (search_k over
   `probe.CUT_SHARE` past the floor), qps and recall; then kernel 3 timed on a real selection of
   blocks, with the share of distinct blocks in the whole selection and
   in the probe's chunks of it, and its rates on total, distinct and read
   bytes;
7. traversal slice (run inside phase 4, on its reopened index) — the
   best-first forest traversal, which ``searcher(engine="forest")``
   resolves to under 262,144 items: batches of 256 of phase 4's queries,
   bench.py's search_k policy against recall@10 vs f32x1, with qps, pops
   per batch, whether the small tier sufficed, the re-score mode and
   CUDA-event times of its four stages; 64 queries held against the same
   searcher on the CPU, `nns()` against the searcher, and one filtered
   batch (10% of the ids); then the multi-pop sweep: P = 1, 4, 16 pops a
   step at search_k 2000, 4000 and 8000, with qps, loop steps and pops a
   batch, device events a batch (`torch.profiler`) and recall@10; P = 1
   must answer as the default searcher did, and P = 16's loop at the full
   budget and an exhaustive search_k as P = 1's.  It has no kernel of its
   own;
8. large-corpus exact serving — 1,000,000 x 768 of the same corpus model
   (drawn on the card, seed 42), euclidean and "binary quantized
   cosine", 10 trees, 2 batches of 2048, whose [B, M] matrix (8.2 GB)
   passes the 4 GiB budget, so each batch streams in 4 chunks of 262,144
   items: f32x1 streams and equals the same searcher on sub-batches of
   256 (the matrix path) and a float64 brute force; bf16 and int8 run
   fused (kernel 1), then streamed (the fused-table cap lowered for that
   searcher), each at recall@10 >= 0.99 against f32x1; kernel 1 held
   against its plain version on each fused searcher's own tables (Mp =
   1,001,472) and one batch's queries; the BQ scan (kernel 2 once a
   chunk) streams and equals the matrix on sub-batches of 256, and
   kernel 2 is held against its plain version on the ragged last chunk
   view, and timed on a full chunk beside its plain version and the ±1
   int8 GEMM.  It prints ms a batch, qps and peak device memory per
   route, the build times and its wall time;
9. incremental build — phase 8's euclidean index, kept: the device
   mirror's two sync paths (patch, full upload) timed at 1-100% dirty
   slots; (a) a 1% update (10,000 ids deleted, 10,000 overwritten with
   fresh rows of the same clusters, 10,000 added) rebuilt incrementally,
   with each progress step's time, the rows the mirror uploaded (at
   most the dirty slots), lanes routed, seeds regrown, node ids kept and
   the forest invariants; (b) a fresh build of the updated corpus; (c)
   the traversal's recall@10 of both at search_k 8000 against f32x1
   (the incremental within 0.02 of the fresh); (d) two warm rebuilds
   after re-adding every item with identical bytes (0 mirror rows);
   (e) a build of 262,144 x 768 within `available_memory(256 MiB)`
   (streaming) beside a resident one: seconds, peak device memory,
   invariants and recall (within 0.02).  It launches no kernel;
10. operator surface — the CLI tools run in-process through `main(argv)`
   on the card, their standard output parsed: (a) `sample_vectors`
   (262,144 x 768, bench.py's corpus model: 64 parents, seed 42) →
   `import_vectors` (10 trees) → `stats` → `check` → `graph` (valid dot
   for the first tree) → `search_bench` (`nns()` in batches of 256, at
   the default search_k and at 8000) → `recall_sweep` at 100,000 items
   with the exact point (kernel 1, recall@10 >= 0.99) and again under
   binary quantized cosine (kernel 2) → `compare_exact` → `fuzz` (10 s) →
   `build_only` → `upgrade` (a no-op); (b) 100,000 x 768 of the same
   corpus written in the 1.0.0 npy layout, one batch of 2048 served by
   the exact engine and the traversal, `upgrade`, reopened: 1.2.0 in a
   container, and the same batch answers bit for bit on both engines;
   (c) a custom metric (euclidean under the name "half-euclidean",
   registered) built over the 262,144 items, reopened from disk and
   served by `searcher(10)`, which must choose the forest and probe
   (kernel 3) to recall@10 >= 0.95 against f32x1 at the first search_k
   of 2000·2^n, and whose forest equals the euclidean one node for node;
   (d) one exact batch inside `utils.profiling.trace`, whose trace must
   name kernel 1's CUDA function.  It prints each part's time and its
   launches per kernel instance;
11. multi-device on one card (`arroy_tpu_torch.parallel`), 4 shards on
   cuda:0 beside 1 shard: (a) `ShardedExactIndex` over phase 8's
   1,000,000 x 768 corpus, 2 batches of 2048, equal (tie-aware) to the
   single-device f32x1 engine at 4 shards and at 1, one filtered batch
   (a third of the ids) against a float64 brute force over the filter,
   BQ cosine at 4 shards (kernel 2 a shard, counted) equal to the
   single-device BQ exact engine and finding every row at distance 0,
   kernel 2 held bit-equal to its plain version on shard 0's words, ms a
   batch and peak GiB; (b)
   `ShardedForestIndex.build` over its first 262,144 rows (4 shards x 10
   trees): `search` and `probe_search` (bf16 tables, kernel 3 counted)
   under bench.py's search_k policy, doubling up to 5 times, to
   recall@10 0.95 against exact, with qps; kernel 3 held against its
   plain version on shard 0's tables; (c) `ArroyBuilder.mesh` over the
   same rows on 4 shards and on 1: equal node for node, valid, traversal
   recall@10 at search_k 8000 within 0.02 of a resident build, the three
   build times, then a 1% update built on the mesh; (d)
   `entry.dryrun_multichip(4)`.

Kernel launch counts are reset right before each main path (phases 4-5,
phase 6, phase 8, phase 9, phase 10, and each part of phase 11: (a)
euclidean, (a) BQ, (b), (c)-(d)) and read right after it: every kernel
of that path must have launched there.  Launches that hold a kernel against its plain
version inside a path (`uncounted`) leave its counts as they were.  The
last lines are the per-kernel JSON record, the nvidia-smi line and the
result.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

M, D, N_TREES, K, BATCH, N_BATCHES = 100_000, 768, 10, 10, 2048, 4
#: the probe slice: 2^18 items, queries in batches of 256 as bench.py serves
#: forest engines, and bench.py's recall target and search_k policy
M_PROBE, B_PROBE, N_PROBE_BATCHES = 262_144, 256, 8
TARGET_RECALL, SEARCH_K0, SK_DOUBLINGS = 0.95, 2000, 3
#: phase 7's multi-pop sweep: pops a step, and the search_k of each
MULTIPOP, MULTIPOP_SK = (1, 4, 16), (2000, 4000, 8000)
#: phase 8: a corpus past the [B, M] budget at B = 2048, served in batches
#: of 2048 (streamed) and held against sub-batches of 256 (the matrix)
M_LARGE, N_LARGE_BATCHES, B_MATRIX = 1_000_000, 2, 256
#: rows drawn (and brute-forced) at a time on the card
CORPUS_SLICE = 65_536
#: phase 10: the upgrade's share of the CLI corpus, and the batch served
#: before and after it
M_UPGRADE, B_UPGRADE = 100_000, 2048
KERNEL_SOURCES = ("fused_select", "hamming", "gather_score")
#: published peaks of one H100 SXM at 700 W (dense): bytes/s and op/s
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def make_corpus(rng, m, d):
    """The bench's clustered corpus (bench.py make_corpus)."""
    parents = rng.standard_normal((64, d)).astype(np.float32)
    pa = rng.integers(64, size=m)
    pb = rng.integers(64, size=m)
    mask = rng.random((m, d)) < 0.5
    x = np.where(mask, parents[pa], parents[pb]).astype(np.float32)
    x += 0.05 * rng.standard_normal((m, d)).astype(np.float32)
    return x


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of `fn` alone: a spin kernel holds the card while the host
    queues every launch, so the events see the launches back to back,
    without the host's time between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms: longer than queueing `reps` calls
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    tb = nbytes / HBM_BPS * 1e3
    to = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def select_inputs(rng, b, mp, d, int8, dev):
    import torch

    qf = rng.standard_normal((b, d)).astype(np.float32)
    xf = rng.standard_normal((mp, d)).astype(np.float32)
    if int8:
        q = torch.from_numpy(np.clip(np.round(qf * 20), -127, 127).astype(np.int8))
        x = torch.from_numpy(np.clip(np.round(xf * 20), -127, 127).astype(np.int8))
    else:
        q = torch.from_numpy(qf).to(torch.bfloat16)
        x = torch.from_numpy(xf).to(torch.bfloat16)
    qsc = rng.random(b).astype(np.float32) + 0.5
    mult = rng.random(mp).astype(np.float32) + 0.5
    add = rng.standard_normal(mp).astype(np.float32)
    add[rng.random(mp) < 0.05] = -np.inf  # dead slots
    return tuple(
        torch.as_tensor(a).to(dev).contiguous() for a in (q, x, qsc, mult, add)
    )


def key_scores(keys, bm):
    """The f32 score a packed key stands for, its lane bits cleared (the
    inverse of the kernel's key packing, within one value quantum)."""
    import torch

    sk = keys & -bm
    return torch.where(sk >= 0, sk, sk ^ 0x7FFFFFFF).view(torch.float32)


def check_select(fs, inputs, int8, bm, q_slice=BATCH, min_equal=0.98):
    """Kernel vs plain version; returns (max |Δkey| in key units, share of
    keys equal, largest bf16 score error over its bound).  int8 keys and
    indices must be equal.  bf16 (f32 sums in another order): indices
    equal where keys are; every key within one value quantum of the plain
    one or within the sums' rounding of it, tol = 1e-5 · qsc·|mult| ·
    |q|·|x| (Cauchy-Schwarz bounds Σ|q_i·x_i|); where the kernel chose
    another item than the plain version, that item's float64 score within
    tol + 2^-14·|score| of the plain version's best; and at least
    `min_equal` of the keys equal (None: not bounded).  A key past one
    quantum is a score that cancels (euclidean's 2q·x − |x|² on clustered
    data), where the sums' rounding is far above one quantum: on such
    data the share of equal keys depends on the data, not the kernel.
    The plain version runs `q_slice` queries at a time (it materializes
    [B, Mp])."""
    import torch

    from arroy_tpu_torch.ops.fused_select import DEAD_KEY_MAX

    keys, idx = fs.fused_block_select(*inputs, bm=bm)
    q, x, qsc, mult, add = inputs
    ref = [fs.fused_block_select_reference(q[s:s + q_slice], x, qsc[s:s + q_slice], mult, add,
                                           bm=bm) for s in range(0, q.shape[0], q_slice)]
    rkeys, ridx = torch.cat([k for k, _ in ref]), torch.cat([i for _, i in ref])
    del ref
    torch.cuda.synchronize()
    dk = (keys.long() - rkeys.long()).abs()
    eq = dk == 0
    frac = float(eq.float().mean())
    worst = 0.0
    if int8:
        assert bool(eq.all()) and torch.equal(idx, ridx), "int8 select differs"
        return int(dk.max()), frac, worst
    if min_equal is not None:
        assert frac >= min_equal, f"only {frac:.4f} of bf16 keys equal"
    assert torch.equal(idx[eq], ridx[eq]), "bf16 indices differ at equal keys"
    dead = rkeys <= DEAD_KEY_MAX
    assert torch.equal(keys <= DEAD_KEY_MAX, dead), "bf16 dead keys differ"
    qn = q.float().norm(dim=1)
    xn = torch.cat([x[s:s + CORPUS_SLICE].float().norm(dim=1)
                    for s in range(0, x.shape[0], CORPUS_SLICE)])

    def tol(b, m):
        return 1e-5 * qsc[b] * mult[m].abs() * qn[b] * xn[m]

    def largest(ratio):
        assert not bool(torch.isnan(ratio).any()), "bf16 score check met a NaN"
        return max(worst, float(ratio.max()))

    far = torch.nonzero((dk > 2 * bm) & ~dead)
    for s in range(0, len(far), CORPUS_SLICE):
        b, j = far[s:s + CORPUS_SLICE].unbind(1)
        err = (key_scores(keys[b, j], bm) - key_scores(rkeys[b, j], bm)).abs()
        worst = largest(err / tol(b, ridx[b, j].long()))
    moved = torch.nonzero((idx != ridx) & ~dead)
    for s in range(0, len(moved), CORPUS_SLICE):
        b, j = moved[s:s + CORPUS_SLICE].unbind(1)
        m, mr = idx[b, j].long(), ridx[b, j].long()
        own = (q[b].double() * x[m].double()).sum(1) * (qsc[b] * mult[m]).double() \
            + add[m].double()
        best = key_scores(rkeys[b, j], bm).double()
        bound = torch.maximum(tol(b, m), tol(b, mr)).double() + best.abs() * 2.0**-14
        worst = largest((own - best).abs() / bound)
    assert worst <= 1.0, f"bf16 scores differ by up to {worst:.3g} times their bound"
    return int(dk.max()), frac, worst


def tensor_core_ops(so_path):
    """Count wgmma (HGMMA/IGMMA) and mma.sync (HMMA/IMMA/BMMA) instructions
    per kernel in a built library's SASS."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HGMMA", "IGMMA", "HMMA", "IMMA", "BMMA"):
                if op in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def check_gather(gs, rows, bid, q):
    """Kernel vs plain version on the same operands: |Δ| <= 1e-5 · Σ_d |row·q|
    (only the summation order differs).  Returns max |Δ|."""
    import torch

    got = gs.gather_score(rows, bid, q)
    want = gs.gather_score_reference(rows, bid, q)
    mag = torch.zeros_like(want)
    for s in range(0, bid.shape[1], 4):  # Σ|row·q| in slabs of 4 blocks
        sl = bid[:, s : s + 4].long()
        mag[:, s : s + 4] = torch.einsum("bcpd,bd->bcp", rows[sl].float().abs(), q.abs())
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool((err <= 1e-5 * mag).all()), f"gather_score differs by {float(err.max())}"
    return float(err.max())


def gather_inputs(rng, dev, nbt, p, d, b, c, dtype):
    """Rows [nbt, p, d], ids [b, c] with one query repeating a block and the
    last block present, f32 queries [b, d]."""
    import torch

    xf = torch.from_numpy(rng.standard_normal((nbt, p, d)).astype(np.float32))
    rows = {"f32": xf, "bf16": xf.to(torch.bfloat16),
            "int8": torch.clamp(torch.round(xf * 40), -127, 127).to(torch.int8)}[dtype]
    bid = rng.integers(nbt, size=(b, c)).astype(np.int32)
    bid[0, :] = bid[0, 0]
    bid[-1, -1] = nbt - 1
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return rows.to(dev), torch.from_numpy(bid).to(dev), q.to(dev)


def run_batches(s, batches, label, times=None):
    """Warm up, then time the searcher over every batch with CUDA events;
    returns the concatenated (ids, dists) on the host.  With `times`, also
    records there the ms per batch under `label`."""
    import torch

    dqs = [s.prepare_queries(b) for b in batches]
    s.device_fn(*dqs[0])
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    res = [s.device_fn(*dq) for dq in dqs]
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    n = sum(len(b) for b in batches)
    say("search", f"{label}: route {s.route}, {n / (ms / 1e3):.1f} qps "
        f"({ms / len(batches):.3f} ms per batch of {len(batches[0])})")
    if times is not None:
        times[label] = ms / len(batches)
    return (
        np.concatenate([i.cpu().numpy() for i, _ in res]),
        np.concatenate([d.cpu().numpy() for _, d in res]),
    )


def recall_of(ids, ref_ids):
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids, ref_ids))
    return hits / ref_ids.size


def tie_aware_equal(ids_a, d_a, ids_b, d_b, rtol=0.0):
    """Sorted distance rows equal (within `rtol`); ids equal wherever the
    distance is unique (within `rtol`) in the row's top-k.  The row's
    largest distance may tie with items past k (a boundary tie), so it is
    exempt."""
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        np.testing.assert_allclose(np.sort(da), np.sort(db), rtol=rtol, atol=0)
        for j in range(len(da)):
            near = np.isclose(da, da[j], rtol=rtol, atol=0)
            if near.sum() == 1 and not near[np.argmax(da)]:
                assert ia[j] == ib[j], f"id differs at a unique distance: {ia} vs {ib}"


def probe_agree(ids_a, d_a, ids_b, d_b, rtol=1e-5):
    """The card's probe against the CPU's: at most 1 differing id per row
    (a bf16 summation-order swap at the k2 cut); rows with the same ids
    have sorted distances equal at `rtol`, and every shared id its
    distance.  Returns the number of differing ids."""
    n_diff = 0
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        diff = len(ia) - len(set(ia.tolist()) & set(ib.tolist()))
        assert diff <= 1, f"{diff} ids differ in one row: {ia} vs {ib}"
        n_diff += diff
        if diff == 0:
            np.testing.assert_allclose(np.sort(da), np.sort(db), rtol=rtol)
        where = {int(i): float(v) for i, v in zip(ib, db)}
        for i, v in zip(ia, da):
            if int(i) in where:
                np.testing.assert_allclose(v, where[int(i)], rtol=rtol)
    return n_diff


def kernel_parity(dev, rec):
    """Phase 3: every kernel against its plain version (kernels 1 and 2
    also timed at the main path's shapes; kernel 3 is timed in phase 6,
    on a selection the probe made)."""
    import torch

    from arroy_tpu_torch.ops import bq_kernels as bk, fused_select as fs, gather_score as gs
    from arroy_tpu_torch.ops.binary import unpack_bits

    rng = np.random.default_rng(0)
    # kernel 1: the main path's shape and one more at bm = 256, then ragged
    # and edge shapes at bm = 1024 (B = 1: under a single warpgroup; B = 65,
    # 130: partial query tiles; Mp = 4096: the smallest corpus the fused
    # gate admits; d = 128: one int8 K-slice)
    select_cases = [(256, 32768, D, 256), (BATCH, 100_352, D, 256)] + [
        (b, mp, d, 1024) for b in (1, 65, 130, BATCH) for mp in (4096, 100_352) for d in (128, D)]
    for name, int8 in (("fused_select_int8", True), ("fused_select_bf16", False)):
        err, least_eq = 0, 1.0
        for b, mp, d, bm in select_cases:
            inputs = select_inputs(rng, b, mp, d, int8, dev)
            e, frac, _ = check_select(fs, inputs, int8, bm)
            err, least_eq = max(err, e), min(least_eq, frac)
            say("parity", f"{name} B={b} Mp={mp} d={d} bm={bm}: max |dkey| {e}, {frac:.5f} of keys equal")
        say("parity", f"{name}: {len(select_cases)} shapes, max |dkey| {err}, least share of keys "
            f"equal {least_eq:.5f}")
        inputs = select_inputs(rng, BATCH, 100_352, D, int8, dev)
        q, x = inputs[0], inputs[1]
        b, mp = q.shape[0], x.shape[0]
        rec[name]["max_abs_err"] = err
        rec[name]["ms"] = cuda_ms(lambda: fs.fused_block_select(*inputs), 10)
        rec[name]["plain_ms"] = cuda_ms(lambda: fs.fused_block_select_reference(*inputs), 3)
        nb = mp // fs.DEFAULT_BM
        nbytes = q.numel() * q.element_size() + x.numel() * x.element_size() \
            + 4 * (b + 2 * mp) + 2 * (b * 2 * nb * 4)
        rec[name].update(bound(nbytes, 2.0 * b * mp * D, "int8" if int8 else "bf16"))
        # no single PyTorch call fuses the GEMM with a per-block top-2; the
        # GEMM alone is timed as the yardstick
        rec[name]["library_ms"] = None
        rec[name]["library"] = "none: no single call fuses GEMM + per-block top-2"
        gemm = (lambda: torch._int_mm(q, x.t())) if int8 else (lambda: torch.matmul(q, x.t()))
        rec[name]["gemm_ms"] = cuda_ms(gemm, 10)
        rec[name]["ms_over_gemm"] = rec[name]["ms"] / rec[name]["gemm_ms"]
        rec[name]["tops"] = 2.0 * b * mp * D / rec[name]["ms"] / 1e9
        say("kernel1", f"{name} at B={b} Mp={mp} d={D}: kernel {rec[name]['ms']:.4f} ms "
            f"({rec[name]['tops']:.1f} T{'OP' if int8 else 'FLOP'}/s), bare GEMM "
            f"{rec[name]['gemm_ms']:.4f} ms, ratio {rec[name]['ms_over_gemm']:.3f}")
        del inputs, q, x
    # kernel 2: every B of {1, 65, 130, 2048} with every M of {1, 127, 1537,
    # 100,000} at w = 24 (d = 768), then w = 1, 7, 8, 9 (around one 8-word
    # k-step), 40 (d = 1280) and 320 (past the SIMT kernel's old cap)
    ham_cases = [(b, m, 24) for b in (1, 65, 130, BATCH) for m in (1, 127, 1537, M)] + [
        (130, 1537, w) for w in (1, 7, 8, 9, 40, 320)]
    for b, m, w in ham_cases:
        qw, xw = (torch.from_numpy(rng.integers(-2**31, 2**31, (n, w), dtype=np.int64)
                                   .astype(np.int32)).to(dev) for n in (b, m))
        h = bk.bq_hamming_matrix(qw, xw)
        hr = bk.bq_hamming_matrix_reference(qw, xw)
        assert torch.equal(h, hr), f"hamming kernel differs from its plain version at B={b} M={m} w={w}"
        say("parity", f"bq_hamming B={b} M={m} w={w}: bit-equal")
        if (b, m, w) == (BATCH, M, 24):
            main_in = (qw, xw, h)  # the main path's shape, timed below
        del qw, xw, h, hr
    qw, xw, h = main_in
    del main_in
    r = rec["bq_hamming"]
    r["max_abs_err"] = 0
    r["ms"] = cuda_ms(lambda: bk.bq_hamming_matrix(qw, xw), 10)
    r["plain_ms"] = cuda_ms(lambda: bk.bq_hamming_matrix_reference(qw, xw), 3)
    # bytes-bound: the [B, M] int32 output (the table has no one-bit
    # tensor-core rate)
    r.update({"bound_ms": (4.0 * (qw.numel() + xw.numel() + h.numel())) / HBM_BPS * 1e3,
              "bound_by": "bytes"})
    # one library call computes the same counts: cdist with p=0 over the
    # unpacked 0/1 bits (unpacked outside the timed window)
    qb = unpack_bits(qw, 24 * 32)
    xb = unpack_bits(xw, 24 * 32)
    qz, xz = (qb > 0).float(), (xb > 0).float()
    assert torch.equal(torch.cdist(qz, xz, p=0), h.float()), "cdist(p=0) differs from the counts"
    r["library_ms"] = cuda_ms(lambda: torch.cdist(qz, xz, p=0), 3)
    r["library"] = "torch.cdist(p=0) over unpacked 0/1 bits"
    del qz, xz
    # the same product as one cuBLAS call: the ±1 dot, 768 - 2 h, int32
    # [B, M] like the kernel's output
    qi, xi = qb.to(torch.int8), xb.to(torch.int8)
    del qb, xb
    assert torch.equal(torch._int_mm(qi, xi.t()), 24 * 32 - 2 * h), "±1 int8 GEMM differs"
    r["gemm_ms"] = cuda_ms(lambda: torch._int_mm(qi, xi.t()), 10)
    r["ms_over_gemm"] = r["ms"] / r["gemm_ms"]
    say("kernel2", f"bq_hamming at B={BATCH} M={M} w=24: kernel {r['ms']:.4f} ms "
        f"({4.0 * h.numel() / r['ms'] / 1e6:.0f} GB/s of output), bound {r['bound_ms']:.4f} ms, "
        f"±1 int8 GEMM {r['gemm_ms']:.4f} ms, ratio {r['ms_over_gemm']:.3f}")
    del qw, xw, h, qi, xi
    # kernel 3 at edge shapes: C = 1, P = 64, 48 and 16, d = 768, 100 (a
    # bf16 row of 200 bytes is not a multiple of 16) and 37 (1-byte int8
    # loads), repeated ids and the last block id, and one block chosen by
    # all 600 pairs (a run across 19 CTAs' slices), each scored both in
    # query order (as calls below SCHEDULE_MIN_BYTES are) and with the
    # pairs sorted by block
    min_bytes = gs.SCHEDULE_MIN_BYTES
    for dtype in ("bf16", "int8", "f32"):
        err = 0.0
        for nbt, p, d, b, c in ((200, 64, 768, 16, 1), (200, 48, 768, 9, 24),
                                (120, 64, 100, 7, 13), (120, 48, 100, 5, 7),
                                (60, 16, 37, 70, 5), (1, 64, 768, 300, 2)):
            inputs = gather_inputs(rng, dev, nbt, p, d, b, c, dtype)
            for gs.SCHEDULE_MIN_BYTES in (min_bytes, 0):
                err = max(err, check_gather(gs, *inputs))
        gs.SCHEDULE_MIN_BYTES = min_bytes
        rec[f"gather_score_{dtype}"]["max_abs_err"] = err
        say("parity", f"gather_score_{dtype}: C=1, P=64/48/16, d=768/100/37, repeated, last "
            f"and hot ids, in query order and sorted by block: max |d| {err:.3g} within "
            f"1e-5 * sum|row*q|")
    for name, r in rec.items():
        if "ms" in r:
            say("parity", f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), library {r['library_ms']}")


def exact_slice(tmp, x, queries, batches):
    """Phases 4-5: the exact engine (kernels 1 and 2), and phase 7 (the
    traversal) on phase 4's index."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer
    from arroy_tpu_torch.device import DeviceIndex
    from arroy_tpu_torch.ops import bq_kernels as bk, fused_select as fs
    from arroy_tpu_torch.search import make_exact_fn

    db = Database(f"{tmp}/euclid", device="cuda")
    w = Writer(db, 0, D, metric="euclidean")
    with db.write() as wtxn:
        t0 = time.perf_counter()
        w.add_items(wtxn, np.arange(M, dtype=np.uint32), x)
        t1 = time.perf_counter()
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    say("slice", f"add_items {t1 - t0:.2f} s, build {t2 - t1:.2f} s, commit {t3 - t2:.2f} s")
    db = Database(f"{tmp}/euclid", device="cuda")  # reopen from disk
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    r.assert_validity()
    st = r.stats()
    say("slice", f"reopened: {r.n_items()} items, {r.n_trees()} trees, "
        f"max depth {max(t.depth for t in st.tree_stats)}, assert_validity ok")

    outs = {}
    for prec in ("f32x1", "bf16", "int8"):
        s = r.searcher(K, engine="exact", precision=prec)
        outs[prec] = run_batches(s, batches, prec)
        if prec != "f32x1":
            assert s.route == "fused_select", s.route
    ref_ids = outs["f32x1"][0]
    for prec in ("bf16", "int8"):
        rc = recall_of(outs[prec][0], ref_ids)
        say("slice", f"{prec} recall@{K} vs f32x1: {rc:.4f}")
        assert rc >= 0.99, f"{prec} recall {rc}"
    # f32x1 against a float64 brute force (ties at f32 resolution allowed)
    x64 = x.astype(np.float64)
    for qi in range(32):
        dq = np.sqrt(((x64 - queries[qi].astype(np.float64)) ** 2).sum(1))
        true = np.sort(dq)[:K]
        got = dq[outs["f32x1"][0][qi]]
        np.testing.assert_allclose(got, true, rtol=1e-5)
        np.testing.assert_allclose(outs["f32x1"][1][qi], true, rtol=1e-5)
    say("slice", "f32x1 ids match a float64 brute force on 32 queries")
    fused_n = sum(fs.launches.values())
    assert fused_n >= 8, f"fused select launched {fused_n} times"

    # 7. the forest traversal on the same reopened index (no kernel of its
    # own, so it adds to no count; its exact reference is f32x1)
    traversal_slice(f"{tmp}/euclid", r, batches[0], ref_ids[: len(batches[0])])

    # 5. BQ slice
    db = Database(f"{tmp}/bq", device="cuda")
    metric = "binary quantized cosine"
    w = Writer(db, 0, D, metric=metric)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(M, dtype=np.uint32), x)
        t0 = time.perf_counter()
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    r = Reader.open(db.read(), 0, db, metric=metric)
    r.assert_validity()
    h0 = bk.launches["bq_hamming"]
    s = r.searcher(K, engine="exact")
    run_batches(s, batches, metric)
    assert s.route == "bq_matrix", s.route
    assert bk.launches["bq_hamming"] > h0, "hamming kernel never launched"
    st = r._state
    plain_idx = DeviceIndex.from_numpy(
        DeviceIndex.build_np(st.metric, st.dims, st.store, st.forest), st.metric, st.dims, "cpu"
    )
    fn, _ = make_exact_fn(plain_idx, K)
    q = s.prepare_queries(batches[0][:64])
    pid, pd = fn(*(t.cpu() for t in q))
    gid, gd = s.device_fn(*q)
    tie_aware_equal(gid.cpu().numpy(), gd.cpu().numpy(), pid.numpy(), pd.numpy())
    say("bq", f"build {t1 - t0:.2f} s, route {s.route}, 64 queries equal the plain run (tie-aware)")


def traversal_stages(fn, dq):
    """One batch through the traversal's stages with CUDA events between
    them; returns the result and the ms of margins, loop, expansion and
    re-score."""
    import torch

    qv, qn, qe, qf = dq
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    m = fn.margins(qv, qf)
    ev[1].record()
    out = fn.walk(m)
    ev[2].record()
    cand = fn.expand(out)
    ev[3].record()
    res = fn.rescore(cand, qv, qn, qe)
    ev[4].record()
    torch.cuda.synchronize()
    return res, [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def traversal_slice(path, r, queries, ref_ids):
    """Phase 7: the best-first traversal at 100,000 x 768 (under 262,144
    items, so `searcher(engine="forest")` resolves to it), batches of
    B_PROBE, bench.py's search_k policy against recall@10 vs f32x1."""
    import torch

    from arroy_tpu_torch import Database, Reader

    t_phase = time.perf_counter()
    batches = [queries[i:i + B_PROBE] for i in range(0, len(queries), B_PROBE)]
    sk = SEARCH_K0
    policy = {}  # search_k -> the default searcher's (ids, dists)
    for step in range(SK_DOUBLINGS + 1):
        s = r.searcher(K, search_k=sk, engine="forest")  # no traversal=
        assert s.route == "traversal", s.route
        fn = s.device_fn
        f0 = fn.fallbacks
        ids, dists = (a[:, :K] for a in run_batches(s, batches, f"traversal sk={sk}"))
        policy[sk] = (ids, dists)
        rc = recall_of(ids, ref_ids)
        pops, small, stages = [], [], []
        for b in batches:
            _, ms = traversal_stages(fn, s.prepare_queries(b))
            p = fn.last_pops.float()
            pops.append((float(p.max()), float(p.mean())))
            small.append(fn.last_small_ok)
            stages.append(ms)
        st = np.mean(stages, axis=0)
        say("traversal", f"sk={sk}: recall@{K} vs f32x1 {rc:.4f}; pmax {fn.pmax}, pmax_small "
            f"{fn.pmax_small}, two_tier {fn.two_tier}, q_cap_small {fn.q_cap_small}, q_cap "
            f"{fn.q_cap}, l_cap {fn.l_cap}; pops per batch max {max(a for a, _ in pops):.0f} / mean "
            f"{np.mean([m for _, m in pops]):.1f}; small tier sufficed in "
            f"{sum(map(bool, small)) if fn.two_tier else 'n/a'} of {len(small)} batches "
            f"({fn.fallbacks - f0} fallbacks in all); re-score "
            f"{fn.rescore_mode(B_PROBE)}; stage ms (CUDA events, mean of {len(batches)}): margins "
            f"{st[0]:.3f}, loop {st[1]:.3f}, expansion {st[2]:.3f}, re-score {st[3]:.3f}")
        if rc >= TARGET_RECALL:
            break
        if step < SK_DOUBLINGS:
            sk *= 2
    assert rc >= TARGET_RECALL, f"traversal recall {rc} < {TARGET_RECALL} at sk={sk}"
    res, _ = traversal_stages(fn, s.prepare_queries(batches[0]))
    assert tuple(res[0].shape) == (B_PROBE, fn.k) and bool(torch.isfinite(res[1][:, :K]).all())
    # the same searchers over the same state on the CPU: the default one
    # (its matmul re-score computes d = |x|² - 2x·q + |q|², which cancels
    # ~1,500 down to ~3.5 here, so a last-bit change in a 768-term dot
    # moves d by up to ~5e-4 relative: rtol 1e-3) and the per-candidate
    # exact re-score that nns() runs (rtol 1e-5)
    t0 = time.perf_counter()
    cpu_db = Database(path, device="cpu")
    cpu_r = Reader.open(cpu_db.read(), 0, cpu_db, metric="euclidean")
    ge = r.searcher(K, search_k=sk, engine="forest", rescore="exact")
    eid, ed = (a[:, :K].cpu().numpy() for a in ge.device_fn(*ge.prepare_queries(batches[0][:64])))
    for rescore, (gid, gd), rtol in (("auto", (ids, dists), 1e-3), ("exact", (eid, ed), 1e-5)):
        cs = cpu_r.searcher(K, search_k=sk, engine="forest", rescore=rescore)
        cid, cd = cs.device_fn(*cs.prepare_queries(batches[0][:64]))
        n_diff = probe_agree(gid[:64], gd[:64], cid[:, :K].numpy(), cd[:, :K].numpy(), rtol)
        say("traversal", f"sk={sk}, rescore {rescore} ({cs.device_fn.rescore_mode(64)}): 64 "
            f"queries agree with the CPU run ({n_diff} ids differ, at most 1 per row; distances "
            f"rtol {rtol:g}; {time.perf_counter() - t0:.2f} s)")
    # nns() on one batch equals the searcher with nns()'s per-candidate re-score
    want = ge(batches[0])
    assert r.nns(K).search_k(sk).by_vectors(batches[0]) == want, "nns() differs from the searcher"
    say("traversal", f"sk={sk}: nns().by_vectors equals searcher(rescore='exact') on {B_PROBE} queries")
    # one filtered batch: 10% of the ids (at least twice search_k, so the
    # filter pool never fits the budget and the filtered loop runs)
    n_cand = min(max(r.n_items() // 10, 2 * sk), r.n_items())
    cand = np.random.default_rng(5).choice(r.n_items(), n_cand, replace=False)
    filt = r.searcher(K, search_k=sk, engine="forest", candidates=cand)
    assert filt.route == "traversal" and filt.device_fn.filter_words is not None, filt.route
    fids = run_batches(filt, batches[:1], f"traversal filtered {n_cand} ids sk={sk}")[0][:, :K]
    assert set(np.unique(fids).tolist()) <= set(cand.tolist()), "filtered result outside the filter"
    rids, _ = run_batches(r.searcher(K, engine="exact", precision="f32x1", candidates=cand),
                          batches[:1], f"f32x1 filtered {n_cand} ids")
    say("traversal", f"filtered {n_cand} ids sk={sk}: recall@{K} vs f32x1 over the filter "
        f"{recall_of(fids, rids):.4f}, pops per query max {int(filt.device_fn.last_pops.max())}")
    multipop_sweep(path, r, batches, ref_ids, policy)
    say("time", f"phase 7 took {time.perf_counter() - t_phase:.1f} s")


def traversal_events(path, qfile):
    """Device-side events (kernels, copies) and device-busy ms of one batch
    of the traversal at each P and search_k of phase 7's sweep, from
    `torch.profiler` (operator events carry the same time again), one JSON
    line each.  Phase 7 runs this in a child process: in the smoke run's
    own process, later `torch.profiler` sessions (phase 10 (d)) recorded
    no device event after these."""
    import torch
    from torch.autograd import DeviceType

    from arroy_tpu_torch import Database, Reader

    db = Database(path, device="cuda")
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    batch = np.load(qfile)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for P in MULTIPOP:
        for sk in MULTIPOP_SK:
            s = r.searcher(K, search_k=sk, engine="forest", multipop=P)
            dq = s.prepare_queries(batch)
            s.device_fn(*dq)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                s.device_fn(*dq)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            print(json.dumps({"P": P, "search_k": sk, "device_events": sum(e.count for e in ev),
                              "device_busy_ms": sum(e.self_device_time_total for e in ev) / 1e3}),
                  flush=True)


def multipop_sweep(path, r, batches, ref_ids, policy):
    """Phase 7's multi-pop sweep: the traversal at P pops a step on its
    small tier, for each P of `MULTIPOP` and search_k of `MULTIPOP_SK`:
    qps, loop steps and pops a batch, device events a batch and recall@10
    against f32x1.  P = 1 must answer as the default searcher did at the
    same search_k; P = 16's loop at the full budget and an exhaustive
    search_k must collect what P = 1's does (64 queries, tie-aware)."""
    out = []
    for P in MULTIPOP:
        for sk in MULTIPOP_SK:
            s = r.searcher(K, search_k=sk, engine="forest", multipop=P)
            fn = s.device_fn
            assert s.route == "traversal" and fn.P == (P if fn.two_tier else 1), (s.route, fn.P)
            times = {}
            ids, dists = (a[:, :K] for a in run_batches(s, batches, f"traversal P={P} sk={sk}", times))
            if P == 1 and sk in policy:
                np.testing.assert_array_equal(ids, policy[sk][0])
                np.testing.assert_array_equal(dists, policy[sk][1])
            steps, pops, f0 = [], [], fn.fallbacks
            for b in batches:
                fn(*s.prepare_queries(b))
                steps.append(fn.last_steps)
                pops.append(float(fn.last_pops.sum()))
            out.append(dict(P=P, P_small_tier=fn.P, search_k=sk, recall=recall_of(ids, ref_ids),
                            qps=len(batches[0]) / (times[f"traversal P={P} sk={sk}"] / 1e3),
                            ms=times[f"traversal P={P} sk={sk}"], steps=float(np.mean(steps)),
                            pops=float(np.mean(pops)), fallbacks=fn.fallbacks - f0))
    # device events of batch 0, profiled in a child process
    qfile = f"{os.path.dirname(path)}/traversal_batch.npy"
    np.save(qfile, batches[0])
    child = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.traversal_events({path!r}, {qfile!r})"],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600,
    )
    assert child.returncode == 0, child.stderr[-3000:]
    events = [json.loads(line) for line in child.stdout.splitlines() if line.startswith("{")]
    assert len(events) == len(out), child.stdout[-3000:]
    for row, ev in zip(out, events):
        assert (row["P"], row["search_k"]) == (ev["P"], ev["search_k"])
        row.update(device_events=ev["device_events"], device_busy_ms=ev["device_busy_ms"])
        say("multipop", json.dumps(row))
    # P = 16's loop at the full budget against P = 1's, at a search_k past
    # every tree's items (both collect every leaf)
    s = r.searcher(K, search_k=10**7, engine="forest", rescore="exact")
    fn = s.device_fn
    dq = s.prepare_queries(batches[0][:64])
    m = fn.margins(dq[0], dq[3])
    got = [fn.rescore(fn.expand(fn.traverse(m, fn.pmax, fn.q_cap, P)[0]), *dq[:3]) for P in (16, 1)]
    (gi, gd), (wi, wd) = ((i[:, :K].cpu().numpy(), d[:, :K].cpu().numpy()) for i, d in got)
    tie_aware_equal(gi, gd, wi, wd)
    say("multipop", f"P=16 at search_k 10^7 (full budget, pmax {fn.pmax}) equals P=1 on 64 "
        f"queries (tie-aware)")
    return out


def probe_slice(tmp):
    """Phase 6: the leaf-probe engine (kernel 3).  Returns, per row type,
    the searcher that met the policy and its batch-0 queries."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer

    rng = np.random.default_rng(42)
    x = make_corpus(rng, M_PROBE + B_PROBE * N_PROBE_BATCHES, D)
    x, queries = x[:M_PROBE], x[M_PROBE:]
    batches = [queries[i * B_PROBE:(i + 1) * B_PROBE] for i in range(N_PROBE_BATCHES)]
    path = f"{tmp}/probe"
    db = Database(path, device="cuda")
    w = Writer(db, 0, D, metric="euclidean")
    with db.write() as wtxn:
        t0 = time.perf_counter()
        w.add_items(wtxn, np.arange(M_PROBE, dtype=np.uint32), x)
        t1 = time.perf_counter()
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    say("probe", f"{M_PROBE} x {D}: add_items {t1 - t0:.2f} s, build {t2 - t1:.2f} s, "
        f"commit {t3 - t2:.2f} s")
    db = Database(path, device="cuda")  # reopen from disk
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    r.assert_validity()
    say("probe", f"reopened: {r.n_items()} items, {r.n_trees()} trees, assert_validity ok")
    ref_ids = run_batches(r.searcher(K, engine="exact", precision="f32x1"), batches, "f32x1")[0]

    cpu_db = Database(path, device="cpu")
    cpu_r = Reader.open(cpu_db.read(), 0, cpu_db, metric="euclidean")
    served = {}
    for dtype in ("auto", "int8", "f32"):
        sk = SEARCH_K0
        for step in range(SK_DOUBLINGS + 1):
            t0 = time.perf_counter()
            s = r.searcher(K, search_k=sk, engine="forest", probe_dtype=dtype)  # no traversal=
            torch.cuda.synchronize()
            bind_s = time.perf_counter() - t0
            assert s.route == "probe", s.route
            fn = s.device_fn
            kind = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float32: "f32"}[fn.tables.blk_rows.dtype]
            if step == 0:
                say("probe", f"{dtype} -> {kind} tables: T={fn.tables.n_trees} P={fn.tables.block} "
                    f"nb_max={fn.tables.nb_max} fill={fn.tables.fill:.3f}, "
                    f"{fn.tables.nbytes() / 2**30:.3f} GiB on the card, built in {bind_s:.2f} s")
            ids, dists = run_batches(s, batches, f"probe {kind} sk={sk} L={fn.L} k2={fn.k2}")
            rc = recall_of(ids, ref_ids)
            say("probe", f"{kind} sk={sk}: recall@{K} vs f32x1 {rc:.4f}")
            if rc >= TARGET_RECALL or kind == "f32":
                break
            if step < SK_DOUBLINGS:
                sk *= 2
        if kind != "f32":  # f32 tables hold half the trees in the same budget
            assert rc >= TARGET_RECALL, f"probe {kind} recall {rc} < {TARGET_RECALL} at sk={sk}"
        served[kind] = (s, sk, ids[:64], dists[:64])
        # the same searcher over the same state on the CPU (plain versions)
        t0 = time.perf_counter()
        cs = cpu_r.searcher(K, search_k=sk, engine="forest", probe_dtype=dtype)
        cid, cd = cs.device_fn(*cs.prepare_queries(batches[0][:64]))
        n_diff = probe_agree(ids[:64], dists[:64], cid.numpy(), cd.numpy())
        say("probe", f"{kind}: 64 queries agree with the CPU run ({n_diff} ids differ, "
            f"at most 1 per row; {time.perf_counter() - t0:.2f} s)")
    probe_cuts(r, batches, ref_ids)
    return served, batches


def probe_cuts(r, batches, ref_ids):
    """The re-score cut's cost: the default (bf16) probe at search_k 4000
    and 8000 with the JAX package's cut (512) and the port's (search_k
    over `probe.CUT_SHARE` past the floor), qps and recall@10 against f32x1."""
    from arroy_tpu_torch import probe

    for sk in (4000, 8000):
        for jax_cut in (True, False):
            probe.JAX_CUT = jax_cut
            try:
                s = r.searcher(K, search_k=sk, engine="forest")
            finally:
                probe.JAX_CUT = False
            label = f"probe cut {'jax' if jax_cut else 'port'} sk={sk} k2={s.device_fn.k2}"
            times = {}
            ids, _ = run_batches(s, batches, label, times)
            say("probe", json.dumps({"search_k": sk, "cut": "jax" if jax_cut else "port",
                                     "k2": s.device_fn.k2, "recall": recall_of(ids, ref_ids),
                                     "qps": len(batches[0]) / (times[label] / 1e3),
                                     "ms": times[label]}))


def time_gather(gs, served, batches, rec):
    """Kernel 3 against its plain version, the two-call path the JAX package
    serves, and its bound, on the [B, C] selection stage 1 made for batch 0."""
    import torch

    from arroy_tpu_torch.probe import gather_chunk

    for kind, (s, sk, _, _) in served.items():
        fn = s.device_fn
        qv = s.prepare_queries(batches[0])[0]
        bid = fn.block_ids(qv).to(torch.int32).contiguous()
        rows = fn.tables.blk_rows
        q = (qv if kind == "f32" else qv.to(torch.bfloat16).float()).contiguous()
        r = rec[f"gather_score_{kind}"]
        r["max_abs_err"] = max(r["max_abs_err"], check_gather(gs, rows, bid, q))
        r["ms"] = cuda_ms(lambda: gs.gather_score(rows, bid, q), 10)
        r["plain_ms"] = cuda_ms(lambda: gs.gather_score_reference(rows, bid, q), 3)
        bl = bid.long()
        if kind == "f32":
            lib = lambda: torch.einsum("bcpd,bd->bcp", rows[bl], q)
            r["library"] = "two calls: blk_rows[bid], einsum (f32)"
        else:
            qb = q.to(torch.bfloat16)
            conv = (lambda g: g.to(torch.bfloat16)) if kind == "int8" else (lambda g: g)
            lib = lambda: torch.einsum("bcpd,bd->bcp", conv(rows[bl]), qb)
            r["library"] = ("three calls: blk_rows[bid], .to(bf16), einsum (bf16)" if kind == "int8"
                            else "two calls: blk_rows[bid], einsum (bf16)")
        r["library_ms"] = cuda_ms(lib, 10)
        b, c = bid.shape
        _, p, d = rows.shape
        uniq = int(torch.unique(bid).numel())
        nbytes = uniq * p * d * rows.element_size() + 4 * (b * c * p + b * d + b * c)
        r.update(bound(nbytes, 2.0 * b * c * p * d, "f32" if kind == "f32" else "bf16"))
        say("kernel3", f"gather_score_{kind} at B={b} C={c} P={p} d={d} (sk={sk}, {uniq} unique "
            f"blocks of {b * c}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.3f} ms ({r['library']}), bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), max |d| {r['max_abs_err']:.3g}")
        # reuse: distinct blocks over pairs for the whole C and for the
        # probe's own chunks of C, and the blocks the kernel reads (once
        # per run of a block within each CTA's slice of the schedule, or
        # once a pair in a call too small to be sorted)
        blk_bytes = p * d * rows.element_size()
        ch = gather_chunk(b, rows)
        chunks = [bid[:, i:i + ch].contiguous() for i in range(0, c, ch)]
        uniq_ch = sum(int(torch.unique(x).numel()) for x in chunks)

        def reads_of(x):
            if x.numel() * blk_bytes < gs.SCHEDULE_MIN_BYTES:
                return x.numel()
            return gs.block_reads(gs.block_schedule(x, rows.shape[0])[0])

        reads, reads_ch = reads_of(bid), sum(reads_of(x) for x in chunks)
        r["distinct_share"] = uniq / (b * c)
        r["chunk_distinct_share"] = uniq_ch / (b * c)
        r["schedule_ms"] = device_ms(lambda: gs.block_schedule(bid, rows.shape[0]), 10)
        r["chunked_ms"] = cuda_ms(lambda: [gs.gather_score(rows, x, q) for x in chunks], 10)
        say("kernel3", f"gather_score_{kind} reuse: {uniq} distinct blocks of {b * c} pairs "
            f"(share {r['distinct_share']:.4f}); in the probe's {len(chunks)} chunks of {ch} "
            f"blocks a query {uniq_ch} (share {r['chunk_distinct_share']:.4f}); blocks the kernel "
            f"reads: {reads} whole, {reads_ch} chunked")
        say("kernel3", f"gather_score_{kind} rates: {b * c * blk_bytes / r['ms'] / 1e6:.0f} GB/s "
            f"of total row bytes, {uniq * blk_bytes / r['ms'] / 1e6:.0f} GB/s of distinct ones, "
            f"{reads * blk_bytes / r['ms'] / 1e6:.0f} GB/s of the blocks it reads; the schedule "
            f"alone {r['schedule_ms']:.4f} ms on the device; the probe's {len(chunks)} chunked "
            f"calls {r['chunked_ms']:.3f} ms (sorted by block where a chunk gathers "
            f"{gs.SCHEDULE_MIN_BYTES >> 20} MiB or more)")


@contextlib.contextmanager
def uncounted(*counters):
    """Kernel launches inside the block (a kernel held against its plain
    version, a reference run) leave the path's launch counts as they
    were."""
    saved = [dict(c) for c in counters]
    try:
        yield
    finally:
        for c, n in zip(counters, saved):
            c.update(n)


def card_corpus(m, d, seed, parents_seed=None):
    """bench.py's clustered corpus model (`make_corpus`) drawn on the card
    from one seeded generator, in slices of `CORPUS_SLICE` rows with the 64
    parents drawn once, then copied to the host (f32): `make_corpus` at
    1M rows would build two 6 GB float64 temporaries on the host.  With
    `parents_seed`, the parents come from that seed and the rows from
    `seed`: fresh rows of another draw's clusters."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed if parents_seed is None else parents_seed)
    parents = torch.randn((64, d), generator=g, device="cuda")
    if parents_seed is not None:
        g = torch.Generator(device="cuda").manual_seed(seed)
    out = np.empty((m, d), np.float32)
    for s in range(0, m, CORPUS_SLICE):
        n = min(CORPUS_SLICE, m - s)
        pa, pb = (torch.randint(64, (n,), generator=g, device="cuda") for _ in range(2))
        mask = torch.rand((n, d), generator=g, device="cuda") < 0.5
        x = torch.where(mask, parents[pa], parents[pb])
        x += 0.05 * torch.randn((n, d), generator=g, device="cuda")
        out[s:s + n] = x.cpu().numpy()
    return out


def brute_force_top(x_dev, q, k):
    """float64 top-k distances of each query against every row (on the
    card, in slices, |x|² - 2x·q + |q|² in float64)."""
    import torch

    q64 = torch.from_numpy(q).cuda().double()
    best = []
    for s in range(0, x_dev.shape[0], CORPUS_SLICE):
        xs = x_dev[s:s + CORPUS_SLICE].double()
        d2 = (xs * xs).sum(1)[None, :] - 2.0 * q64 @ xs.T + (q64 * q64).sum(1)[:, None]
        best.append(torch.topk(d2, k, dim=1, largest=False).values)
    d2 = torch.topk(torch.cat(best, dim=1), k, dim=1, largest=False).values
    return torch.sqrt(torch.clamp(d2, min=0.0)).cpu().numpy()


def large_slice(rec):
    """Phase 8: the exact engine past the [B, M] matrix budget, at
    1,000,000 x 768 and B = 2048 (B·M·4 = 8.2 GB > 4 GiB, so every batch of
    2048 streams in chunks of 262,144 items, the last one ragged).  Prints
    the route records (ms a batch, qps, peak device GiB, checks), adds
    kernel 1's check and kernel 2's time at this phase's shapes to `rec`,
    and returns the kernel launches the path made (not those of the
    comparisons and timing, which run `uncounted`)."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer, search
    from arroy_tpu_torch.models import items
    from arroy_tpu_torch.ops import bq_kernels as bk, fused_select as fs
    from arroy_tpu_torch.ops.binary import unpack_bits

    t_phase = time.perf_counter()
    # the stores' device mirrors of earlier phases' indexes (an LRU of
    # resident f32 rows) would count in this phase's held and peak memory
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    routes = {}
    times = {}
    t0 = time.perf_counter()
    x = card_corpus(M_LARGE + BATCH * N_LARGE_BATCHES, D, 42)
    x, queries = x[:M_LARGE], x[M_LARGE:]
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(N_LARGE_BATCHES)]
    sub = [b[i:i + B_MATRIX] for b in batches for i in range(0, BATCH, B_MATRIX)]
    say("large", f"{M_LARGE} x {D} corpus drawn in {time.perf_counter() - t0:.2f} s")
    assert BATCH * M_LARGE * 4 > search._EXACT_DOTS_BYTES >= B_MATRIX * M_LARGE * 4
    chunk = search._scan_chunk(BATCH)
    say("large", f"B={BATCH}: chunk {chunk} items, {-(-M_LARGE // chunk)} chunks a batch, the "
        f"last {M_LARGE - (M_LARGE // chunk) * chunk} wide; B={B_MATRIX} builds the [B, M] matrix")

    def serve(s, label, bs=batches):
        """One route over `bs`: ids, dists, with ms a batch, qps and peak GiB
        recorded under `label`."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        ids, dists = run_batches(s, bs, label, times)
        rec = routes.setdefault(label, {})
        rec.update(ms=times[label], qps=len(bs[0]) / (times[label] / 1e3), batch=len(bs[0]),
                   held_gib=held, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        say("large", f"{label}: peak device memory {rec['peak_gib']:.2f} GiB ({held:.2f} GiB "
            f"held before the route's first batch)")
        return ids[:, :K], dists[:, :K]

    def scans(key, fn):
        n0 = search.scan_calls[key]
        out = fn()
        return out, search.scan_calls[key] - n0

    def build(metric):
        nonlocal db
        db = Database(None, device="cuda")
        w = Writer(db, 0, D, metric=metric)
        with db.write() as wtxn:
            t0 = time.perf_counter()
            w.add_items(wtxn, np.arange(M_LARGE, dtype=np.uint32), x)
            t1 = time.perf_counter()
            w.builder(seed=42).n_trees(N_TREES).build(wtxn)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        r = Reader.open(db.read(), 0, db, metric=metric)
        routes[f"build {metric}"] = {"add_items_s": t1 - t0, "build_s": t2 - t1}
        say("large", f"{metric}: add_items {t1 - t0:.2f} s, build ({N_TREES} trees) {t2 - t1:.2f} s")
        return r

    # euclidean: f32x1 streams; the same searcher under the budget builds
    # the matrix; the float64 brute force on 32 queries
    db = None
    r = build("euclidean")
    s = r.searcher(K, engine="exact", precision="f32x1")
    (ref_ids, ref_d), n = scans("exact_scan", lambda: serve(s, "f32x1 scan"))
    assert n == N_LARGE_BATCHES + 1, f"f32x1 streamed {n} batches"
    with uncounted(fs.launches, bk.launches):
        (mids, md), n = scans("exact_scan", lambda: serve(s, f"f32x1 matrix B={B_MATRIX}", sub))
    assert n == 0, "a sub-batch streamed"
    tie_aware_equal(ref_ids, ref_d, mids, md, rtol=1e-5)
    say("large", f"f32x1: the scan equals the matrix path on {len(queries)} queries (tie-aware, "
        f"rtol 1e-5)")
    x_dev = torch.from_numpy(x).cuda()
    true = brute_force_top(x_dev, queries[:32], K)
    del x_dev
    np.testing.assert_allclose(ref_d[:32], true, rtol=1e-5)
    got = np.sqrt(((x[ref_ids[:32]].astype(np.float64) - queries[:32, None, :]) ** 2).sum(-1))
    np.testing.assert_allclose(got, true, rtol=1e-5)
    say("large", "f32x1 scan ids and distances match a float64 brute force on 32 queries "
        "(rtol 1e-5)")

    # bf16 / int8: fused (kernel 1), then the scan forced by a zero table cap
    # for that searcher, the route tables past the cap take
    for prec in ("bf16", "int8"):
        s = r.searcher(K, engine="exact", precision=prec)
        assert s.route == "fused_select", s.route
        (ids, _), n = scans("exact_scan", lambda: serve(s, f"{prec} fused"))
        assert n == 0
        routes[f"{prec} fused"]["recall"] = rc = recall_of(ids, ref_ids)
        say("large", f"{prec} fused: recall@{K} vs f32x1 {rc:.4f}")
        assert rc >= 0.99, f"{prec} fused recall {rc}"
        # kernel 1 against its plain version at this corpus: the searcher's
        # own tables and the first batch's queries, quantized as it does
        int8 = prec == "int8"
        xq, mult, add, _ = s.device_fn.tables
        q, qsc = search._fused_queries(s.prepare_queries(batches[0])[0], xq.shape[1], int8)
        with uncounted(fs.launches):
            e, frac, worst = check_select(fs, (q, xq, qsc, mult, add), int8, fs.DEFAULT_BM,
                                          q_slice=256, min_equal=None)
        rec[f"fused_select_{prec}"]["phase8_check"] = {
            "B": q.shape[0], "Mp": xq.shape[0], "max_dkey": e, "keys_equal": frac,
            "score_err_over_bound": worst}
        say("kernel1", f"fused_select_{prec} on the searcher's tables, B={q.shape[0]} "
            f"Mp={xq.shape[0]} d={xq.shape[1]}: max |dkey| {e}, {frac:.5f} of keys equal, "
            f"largest score error {worst:.3g} of its bound")
        del s, q, qsc, xq, mult, add
        cap, search._FUSED_TABLE_BYTES = search._FUSED_TABLE_BYTES, 0
        s = r.searcher(K, engine="exact", precision=prec)
        search._FUSED_TABLE_BYTES = cap
        assert s.route == "unfused", s.route
        (ids, _), n = scans("exact_scan", lambda: serve(s, f"{prec} scan"))
        assert n == N_LARGE_BATCHES + 1, f"{prec} streamed {n} batches"
        routes[f"{prec} scan"]["recall"] = rc = recall_of(ids, ref_ids)
        say("large", f"{prec} scan (bf16 rows): recall@{K} vs f32x1 {rc:.4f}")
        assert rc >= 0.99, f"{prec} scan recall {rc}"
        del s
    del r
    # the euclidean index stays for phase 9; its device copies go, so that
    # the BQ routes' memory counts only their own
    base = db
    db._device_cache.clear()
    items._DEVICE_MIRROR.clear()  # the euclidean index's rows
    torch.cuda.empty_cache()

    # binary quantized cosine: the scan (kernel 2 once a chunk), and the
    # matrix on sub-batches
    r = build("binary quantized cosine")
    s = r.searcher(K, engine="exact")
    assert s.route == "bq_matrix", s.route
    h0 = bk.launches["bq_hamming"]
    (scan, n) = scans("bq_scan", lambda: serve(s, "BQ scan"))
    per_batch = (bk.launches["bq_hamming"] - h0) / (N_LARGE_BATCHES + 1)
    assert n == N_LARGE_BATCHES + 1, f"the BQ scan served {n} batches"
    assert per_batch >= 4, f"kernel 2 launched {per_batch} times a batch"
    routes["BQ scan"]["kernel2_launches_a_batch"] = per_batch
    # the path's launches, read before the comparisons and timing below
    path_launches = {**dict(fs.launches), **dict(bk.launches)}
    with uncounted(bk.launches):
        (mat, n) = scans("bq_scan", lambda: serve(s, f"BQ matrix B={B_MATRIX}", sub))
    assert n == 0
    tie_aware_equal(*scan, *mat)
    same = float(np.mean(np.all(scan[0] == mat[0], axis=1)))
    say("large", f"BQ: the scan equals bq_matrix on sub-batches of {B_MATRIX} (bit-equal "
        f"distances, tie-aware ids, {same:.4f} of rows identical); kernel 2 launched "
        f"{per_batch:.0f} times a batch")
    # kernel 2 at the scan's own shapes: bit-equal to its plain version on
    # the ragged last chunk (a view 786,432 rows into the packed words),
    # timed on a full chunk
    qw = s.prepare_queries(batches[0])[0].contiguous()
    words = s._dev.rows
    last = words[(M_LARGE // chunk) * chunk:]
    full = words[:chunk]
    r2 = rec["bq_hamming"]
    with uncounted(bk.launches):
        assert torch.equal(bk.bq_hamming_matrix(qw, last),
                           bk.bq_hamming_matrix_reference(qw, last)), \
            "kernel 2 differs from its plain version on the last chunk view"
        r2["chunk_ms"] = cuda_ms(lambda: bk.bq_hamming_matrix(qw, full), 10)
        h = bk.bq_hamming_matrix(qw, full)
    r2["chunk_bound_ms"] = 4.0 * (qw.numel() + full.numel() + BATCH * chunk) / HBM_BPS * 1e3
    r2["chunk_plain_ms"] = cuda_ms(lambda: bk.bq_hamming_matrix_reference(qw, full), 1)
    # the ±1 int8 GEMM that computes the same counts (768 - 2 h), as in
    # phase 3, at the chunk's shape
    qi, xi = (unpack_bits(t, D).to(torch.int8) for t in (qw, full))
    assert torch.equal(torch._int_mm(qi, xi.t()), D - 2 * h), "±1 int8 GEMM differs"
    r2["chunk_gemm_ms"] = cuda_ms(lambda: torch._int_mm(qi, xi.t()), 10)
    say("kernel2", f"bq_hamming on chunk views of the 1M corpus: bit-equal on the last "
        f"({last.shape[0]} rows, {last.data_ptr() % 16} bytes past 16-byte alignment); "
        f"B={BATCH} x {chunk} rows, w={words.shape[1]}: {r2['chunk_ms']:.4f} ms, bound "
        f"{r2['chunk_bound_ms']:.4f} ms (bytes), plain {r2['chunk_plain_ms']:.2f} ms, ±1 int8 "
        f"GEMM {r2['chunk_gemm_ms']:.4f} ms")
    del r, s, qw, words, last, full, h, qi, xi
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    say("large", json.dumps({"phase8_s": wall, "routes": routes}))
    say("time", f"phase 8 took {wall:.1f} s")
    return path_launches, base, queries


#: phase 9: the share of the corpus each change touches (deleted, then
#: overwritten, then added under new ids), the traversal's search_k and
#: batches for recall, and the budget build's memory
UPDATE_N, SK_INCREMENTAL, B_RECALL, N_RECALL_BATCHES = 10_000, 8000, 256, 2
BUDGET_BYTES = 256 << 20
#: the progress steps phase 9 times, by what they do
BUILD_STEPS = {"REMOVE_ITEMS_FROM_EXISTING_TREES": "delete", "RETRIEVING_THE_ITEMS": "mirror",
               "INSERT_ITEMS_IN_CURRENT_TREES": "route", "CREATE_TREES_FOR_ITEMS": "regrow",
               "WRITE_THE_METADATA": "finish"}


def timed_build(w, wtxn, seed, memory=None):
    """One `build` with `N_TREES`: (seconds, seconds per progress step, the
    writer's build_stats).  Each progress callback synchronises the card
    before it reads the clock, so a step's device work counts in it."""
    import torch

    from arroy_tpu_torch import writer

    marks = []

    def progress(p):
        torch.cuda.synchronize()
        marks.append((BUILD_STEPS.get(p.main.name, p.main.name), time.perf_counter()))

    b = w.builder(seed=seed).n_trees(N_TREES).progress(progress)
    if memory is not None:
        b.available_memory(memory)
    t0 = time.perf_counter()
    b.build(wtxn)
    torch.cuda.synchronize()
    marks.append(("end", time.perf_counter()))
    steps = {}
    for (name, t), (_, tn) in zip(marks, marks[1:]):
        steps[name] = steps.get(name, 0.0) + tn - t
    return marks[-1][1] - t0, steps, dict(writer.build_stats)


def step_text(steps):
    return ", ".join(f"{k} {steps.get(k, 0.0):.3f}" for k in BUILD_STEPS.values())


def check_forest(r, label):
    """The invariants: every live item in exactly one leaf of every tree,
    no node shared or left over (`assert_validity`), every leaf within
    split_after unless a safety valve fired; returns the largest leaf."""
    from arroy_tpu_torch import writer
    from arroy_tpu_torch.models.forest import KIND_LEAF

    r.assert_validity()
    f = r._state.forest
    assert r.n_trees() == N_TREES
    biggest = max(len(f.leaves[int(n)]) for n in np.nonzero(f.kind == KIND_LEAF)[0])
    valve = writer.build_stats.get("valve_items", 0)
    say("incremental", f"{label}: forest invariants hold ({r.n_trees()} trees, "
        f"{len(f.leaves)} leaves, largest {biggest} of split_after {D}, valve items {valve})")
    assert biggest <= D or valve > 0, f"{label}: a leaf of {biggest} items"
    return biggest


def forest_recall(readers, queries, ref_ids):
    """recall@K of each reader's traversal at `SK_INCREMENTAL` against
    `ref_ids`, over `N_RECALL_BATCHES` batches of `B_RECALL`."""
    batches = [queries[i * B_RECALL:(i + 1) * B_RECALL] for i in range(N_RECALL_BATCHES)]
    out = []
    for label, r in readers:
        s = r.searcher(K, search_k=SK_INCREMENTAL, engine="forest", traversal="xla")
        assert s.route == "traversal", s.route
        ids, _ = run_batches(s, batches, f"{label} traversal sk={SK_INCREMENTAL}")
        out.append(recall_of(ids[:, :K], ref_ids))
    return out


def exact_ids(r, queries):
    batches = [queries[i * B_RECALL:(i + 1) * B_RECALL] for i in range(N_RECALL_BATCHES)]
    s = r.searcher(K, engine="exact", precision="f32x1")
    return run_batches(s, batches, "f32x1 reference")[0][:, :K]


def mirror_paths(store, dev, rec):
    """The mirror's two sync paths on `store`'s resident mirror, at several
    shares of dirty slots: the patch (host gather of the dirty rows, one
    upload, `index_copy_` into a device copy) against the full upload."""
    import torch

    from arroy_tpu_torch.models import items

    mirror = items._DEVICE_MIRROR[store._lineage][1:]
    cap = store.capacity()
    rng = np.random.default_rng(5)
    out = {}
    for share in (0.01, 0.05, 0.25, 0.5, 1.0):
        idx = np.sort(rng.choice(cap, int(cap * share), replace=False))
        row = {}
        for name, fn in (("full", lambda: store._upload_all(dev)),
                         ("patch", lambda: store._patch(mirror, idx, dev)),
                         ("full2", lambda: store._upload_all(dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            row[name] = time.perf_counter() - t0
            del got
        out[share] = {"patch_s": row["patch"], "full_s": min(row["full"], row["full2"])}
    rec["mirror_paths"] = out
    say("incremental", "mirror sync at dirty shares (s, host clock, synchronised): " + ", ".join(
        f"{k:g}: patch {v['patch_s']:.3f} / full {v['full_s']:.3f}" for k, v in out.items()))


def incremental_slice(db, queries):
    """Phase 9: the incremental build at full width, on phase 8's 1M x 768
    euclidean index (10 trees): (a) a 1% update (deletes, overwrites, new
    ids) rebuilt incrementally; (b) a fresh build of the updated corpus;
    (c) the traversal's recall@10 of both; (d) two warm rebuilds after
    re-adding every item with identical bytes; (e) a memory-budgeted build
    at 262,144 x 768 beside a resident one."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer
    from arroy_tpu_torch.models import items

    t_phase = time.perf_counter()
    rec = {}
    w = Writer(db, 0, D)
    # the serving state: a reader of the committed index holds its mirror
    t0 = time.perf_counter()
    Reader.open(db.read(), 0, db)._device()
    torch.cuda.synchronize()
    rec["base_mirror"] = {"rows": items.mirror_rows_uploaded, "s": time.perf_counter() - t0}
    say("incremental", f"base index: mirror of {items.mirror_rows_uploaded} rows uploaded in "
        f"{rec['base_mirror']['s']:.2f} s")
    before = db.read().state(0)
    used_before = before.forest.used_node_ids()
    cap_before = before.store.capacity()
    mirror_paths(before.store, db.device, rec)

    # (a) the 1% update: delete, overwrite, add (into the freed slots)
    ids = np.random.default_rng(9).permutation(M_LARGE)
    gone, moved = ids[:UPDATE_N], ids[UPDATE_N:2 * UPDATE_N]
    new_ids = np.arange(M_LARGE, M_LARGE + UPDATE_N)
    fresh = card_corpus(2 * UPDATE_N, D, 43, parents_seed=42)
    with db.write() as wtxn:
        assert w.del_items(wtxn, gone) == UPDATE_N
        w.add_items(wtxn, moved, fresh[:UPDATE_N])
        w.add_items(wtxn, new_ids, fresh[UPDATE_N:])
        sec, steps, stats = timed_build(w, wtxn, seed=45)
        cap = wtxn.state(0).store.capacity()
    rec["update"] = {"build_s": sec, "steps_s": steps, **stats}
    say("incremental", f"(a) 1% update ({UPDATE_N} deleted, {UPDATE_N} overwritten, {UPDATE_N} "
        f"added): build {sec:.2f} s; steps (s) {step_text(steps)}")
    say("incremental", f"(a) mirror rows uploaded {stats['mirror_rows']} of {cap} (capacity "
        f"{cap_before} -> {cap}); lanes routed {stats['routed_lanes']}; seeds regrown "
        f"{stats['seeds']} holding {stats['seed_items']} items; valve items {stats['valve_items']}")
    assert not stats["streaming"]
    assert stats["mirror_rows"] <= 2 * UPDATE_N + (cap - cap_before), stats
    assert stats["routed_lanes"] == 2 * UPDATE_N * N_TREES, stats
    r_inc = Reader.open(db.read(), 0, db)
    check_forest(r_inc, "(a) incremental")
    live = r_inc._state.metadata.items
    assert not live.contains_many(gone.astype(np.uint32)).any()
    assert live.contains_many(new_ids.astype(np.uint32)).all() and len(live) == M_LARGE
    used_after = r_inc._state.forest.used_node_ids()
    kept = len(np.intersect1d(used_before, used_after))
    rec["update"]["nodes_kept"] = [kept, len(used_before), len(used_after)]
    say("incremental", f"(a) node ids surviving from before: {kept} of {len(used_before)} "
        f"({kept / len(used_before):.4f}); {len(used_after)} nodes now")

    # (b) a fresh build of the same updated corpus
    st = r_inc._state
    all_ids = st.store.ids()
    vecs = st.store.rows()[st.store.slots_of(all_ids)]
    fdb = Database(None, device="cuda")
    fw = Writer(fdb, 0, D)
    with fdb.write() as wtxn:
        t0 = time.perf_counter()
        fw.add_items(wtxn, all_ids, vecs)
        t_add = time.perf_counter() - t0
        fsec, _, _ = timed_build(fw, wtxn, seed=42)
    rec["fresh"] = {"add_items_s": t_add, "build_s": fsec}
    say("incremental", f"(b) fresh build of the updated corpus: add_items {t_add:.2f} s, build "
        f"{fsec:.2f} s (incremental: {sec:.2f} s, {sec / fsec:.3f} of it)")
    r_fresh = Reader.open(fdb.read(), 0, fdb)

    # (c) recall@10 of both against f32x1 on the updated corpus
    ref = exact_ids(r_inc, queries)
    rc_inc, rc_fresh = forest_recall((("incremental", r_inc), ("fresh", r_fresh)), queries, ref)
    rec["recall"] = {"incremental": rc_inc, "fresh": rc_fresh}
    say("incremental", f"(c) traversal recall@{K} at search_k {SK_INCREMENTAL} vs f32x1: "
        f"incremental {rc_inc:.4f}, fresh {rc_fresh:.4f}")
    assert rc_inc >= rc_fresh - 0.02, (rc_inc, rc_fresh)
    # the fresh index's mirror goes; the incremental index's stays for (d)
    items._DEVICE_MIRROR.pop(r_fresh._state.store._lineage)
    del r_fresh, fdb, fw, vecs
    torch.cuda.empty_cache()

    # (d) warm rebuilds: every item re-added with identical bytes, twice
    warm = []
    for seed in (43, 44):
        with db.write() as wtxn:
            st = wtxn.state(0)
            all_ids = st.store.ids()
            vecs = st.store.rows()[st.store.slots_of(all_ids)]
            t0 = time.perf_counter()
            w.add_items(wtxn, all_ids, vecs)
            t_add = time.perf_counter() - t0
            wsec, steps, stats = timed_build(w, wtxn, seed=seed)
        warm.append({"add_items_s": t_add, "build_s": wsec, "steps_s": steps,
                     "mirror_rows": stats["mirror_rows"]})
        say("incremental", f"(d) warm rebuild seed {seed}: add_items {t_add:.2f} s, build "
            f"{wsec:.2f} s, mirror rows uploaded {stats['mirror_rows']}; steps (s) "
            f"{step_text(steps)}")
        assert stats["mirror_rows"] == 0, stats
    rec["warm"] = warm
    check_forest(Reader.open(db.read(), 0, db), "(d) warm rebuild")
    del r_inc, w, st, vecs
    db.close()  # its device index goes, so (e) holds only its own
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()

    # (e) the budget build at 262,144 x 768 beside a resident build
    xb = card_corpus(M_PROBE + N_RECALL_BATCHES * B_RECALL, D, 42)
    xb, qb = xb[:M_PROBE], xb[M_PROBE:]
    out = []
    for label, memory in (("resident", None), ("budget", BUDGET_BYTES)):
        bdb = Database(None, device="cuda")
        bw = Writer(bdb, 0, D)
        with bdb.write() as wtxn:
            bw.add_items(wtxn, np.arange(M_PROBE, dtype=np.uint32), xb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            bsec, steps, stats = timed_build(bw, wtxn, seed=42, memory=memory)
            peak = torch.cuda.max_memory_allocated() / 2**30
        rb = Reader.open(bdb.read(), 0, bdb)
        check_forest(rb, f"(e) {label}")
        out.append((label, rb))
        rec[label] = {"build_s": bsec, "peak_gib": peak, "held_gib": held, "steps_s": steps,
                      **stats}
        say("incremental", f"(e) {label} build of {M_PROBE} x {D}: {bsec:.2f} s, peak device "
            f"memory {peak:.2f} GiB, {peak - held:.2f} above the {held:.2f} held before; "
            f"streaming {stats['streaming']}, "
            f"budget items {stats['budget_items']}, seeds {stats['seeds']}; steps (s) "
            f"{step_text(steps)}")
    assert not rec["resident"]["streaming"] and rec["budget"]["streaming"]
    assert rec["budget"]["budget_items"] < M_PROBE
    ref = exact_ids(out[0][1], qb)
    rc_res, rc_bud = forest_recall(out, qb, ref)
    rec["recall_budget"] = {"resident": rc_res, "budget": rc_bud}
    say("incremental", f"(e) traversal recall@{K} at search_k {SK_INCREMENTAL}: resident "
        f"{rc_res:.4f}, budget {rc_bud:.4f}")
    assert rc_bud >= rc_res - 0.02, (rc_res, rc_bud)
    del out, rb
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    rec["phase9_s"] = wall
    say("incremental", json.dumps(rec))
    say("time", f"phase 9 took {wall:.1f} s")


NUM = r"([0-9]+(?:\.[0-9]+)?)"


def run_tool(name, argv, prints=True):
    """One CLI tool in-process through its `main(argv)` on the card; returns
    its standard output, each of whose first lines is echoed.  A tool that
    raises fails the phase, and so does one that prints nothing where it
    should (`prints`)."""
    tool = importlib.import_module(f"arroy_tpu_torch.cli.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tool.main(argv)
    out = buf.getvalue()
    lines = out.splitlines()
    for line in lines[:14]:
        say("cli", f"  {line}")
    if len(lines) > 14:
        say("cli", f"  ... ({len(lines) - 14} more lines)")
    say("cli", f"{name} {' '.join(argv)}: {time.perf_counter() - t0:.2f} s")
    assert out.strip() or not prints, f"{name} printed nothing"
    return out


def grab(pattern, out):
    """The numbers of `pattern`'s groups in `out` (the tool printed it)."""
    m = re.search(pattern, out)
    assert m, f"expected {pattern!r} in {out!r}"
    return [float(g) for g in m.groups()]


@contextlib.contextmanager
def env(name, value):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def check_dot(path, forest):
    """`graph`'s file is Graphviz dot of the first tree: every split has two
    out-edges, every leaf of the tree is labelled once, and the root's two
    edges count every item of the tree."""
    from arroy_tpu_torch.models.forest import KIND_LEAF

    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "digraph {" and lines[-1] == "}", (lines[:3], lines[-2:])
    root = int(forest.roots[0])
    assert f"\t\troot -> {root}" in lines
    edges = [tuple(map(int, m.groups())) for m in
             (re.fullmatch(r'\t\t(\d+) -> (\d+) \[taillabel="(\d+)"\]', ln) for ln in lines) if m]
    leaves = [int(m.group(1)) for m in (re.fullmatch(r'\t\t(\d+) \[label="\d+"\]', ln) for ln in lines) if m]
    out = {}
    for a, b, _ in edges:
        out.setdefault(a, []).append(b)
    assert all(len(v) == 2 for v in out.values())
    tree_leaves, stack = [], [root]
    while stack:
        nid = stack.pop()
        if forest.kind[nid] == KIND_LEAF:
            tree_leaves.append(nid)
        else:
            assert sorted(out[nid]) == sorted((int(forest.left[nid]), int(forest.right[nid])))
            stack += out[nid]
    assert sorted(leaves) == sorted(tree_leaves)
    n_items = sum(n for a, _, n in edges if a == root)
    return len(edges), len(leaves), n_items


def same_forest(a, b) -> bool:
    """Node for node: kinds, children, pointers, normals, biases, roots and
    every leaf's ids."""
    arrays = ("kind", "left", "right", "ptr", "normals", "aux")
    return (all(np.array_equal(getattr(a, n), getattr(b, n)) for n in arrays)
            and list(a.roots) == list(b.roots) and a.leaves.keys() == b.leaves.keys()
            and all(np.array_equal(a.leaves[n], b.leaves[n]) for n in a.leaves))


def operator_slice(tmp):
    """Phase 10: the CLI, the 1.0.0 → 1.2.0 upgrade, a custom metric and the
    profiler, on the card.  Returns the launches of each kernel instance in
    the phase."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer, internals
    from arroy_tpu_torch.metrics import Euclidean
    from arroy_tpu_torch.models import items
    from arroy_tpu_torch.ops import bq_kernels as bk, fused_select as fs, gather_score as gs
    from arroy_tpu_torch.utils import profiling
    from arroy_tpu_torch.version import CURRENT_VERSION

    counters = (fs.launches, bk.launches, gs.launches)

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    t_phase = time.perf_counter()
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    rec = {}

    def part_done(part, t0, c0):
        moved = {k: n - c0[k] for k, n in counts().items() if n != c0[k]}
        rec[part] = {"s": time.perf_counter() - t0, "launches": moved}
        say("cli", f"part ({part}) took {rec[part]['s']:.1f} s, launches {json.dumps(moved)}")

    # (a) the CLI at full width
    t0, c0 = time.perf_counter(), counts()
    vec, qvec, db = f"{tmp}/v.npy", f"{tmp}/q.npy", f"{tmp}/db"
    model = ["--dimensions", str(D), "--parents", "64", "--seed", "42"]
    run_tool("sample_vectors", ["--count", str(M_PROBE), "-o", vec] + model, prints=False)
    # the queries: fresh rows of the same 64 parents (same seed, other count)
    run_tool("sample_vectors", ["--count", str(B_UPGRADE), "-o", qvec] + model, prints=False)
    x, q = np.load(vec), np.load(qvec)
    assert x.shape == (M_PROBE, D) and q.shape == (B_UPGRADE, D)
    out = run_tool("import_vectors", ["--db", db, "--n-trees", str(N_TREES), vec])
    grab(rf"inserted {M_PROBE} x {D}-d vectors in {NUM}s\nbuilt in {NUM}s; committed", out)
    out = run_tool("stats", ["--db", db])
    assert f"index 0: {M_PROBE} items, {N_TREES} trees, {D} dims, version {CURRENT_VERSION}" in out, out
    depths = [int(d) for d in re.findall(r"tree \d+: depth=(\d+) ", out)]
    assert len(depths) == N_TREES, out
    grab(r"device \(HBM\) footprint: " + NUM + " MiB", out)
    out = run_tool("check", ["--db", db])
    assert "index 0: container CRCs OK" in out, out
    assert f"index 0: structure OK - {M_PROBE} items, {N_TREES} trees, {D} dims" in out, out
    run_tool("graph", ["--db", db, "-o", f"{tmp}/tree0.dot"], prints=False)
    rdb = Database(db)
    euc = Reader.open(rdb.read(), 0, rdb)
    n_edges, n_leaves, n_items = check_dot(f"{tmp}/tree0.dot", euc._state.forest)
    assert n_items == M_PROBE, n_items
    say("cli", f"graph: valid dot for tree 0: {n_edges} edges, {n_leaves} leaves, "
        f"{n_items} items under the root")
    for argv in (["--count", "10", "--batch", "256"],
                 ["--traversal", "xla", "--search-k", "8000", "--batch", "256"]):
        out = run_tool("search_bench", ["--db", db] + argv)
        assert grab(rf"1000 queries in {NUM}s -> {NUM} qps \(batch=256\)", out)[1] > 0
    sweep = ["--m", str(M), "--search-k", "8000", "--exact-point"]
    for metric in ("euclidean", "binary quantized cosine"):
        c1 = counts()
        out = run_tool("recall_sweep", sweep + ["--distance", metric])
        rc_forest, qps = grab(rf"search_k=\s*8000\s+recall@{K}={NUM}\s+qps=\s*{NUM}", out)
        rc_exact, _ = grab(rf"exact\s+recall@{K}={NUM}\s+qps=\s*{NUM}", out)
        moved = {k: n - c1[k] for k, n in counts().items() if n != c1[k]}
        if metric == "euclidean":
            assert rc_exact >= 0.99, rc_exact
            assert moved.get("fused_select_bf16", 0) + moved.get("fused_select_int8", 0) > 0, moved
        else:
            assert moved.get("bq_hamming", 0) > 0, moved
        say("cli", f"recall_sweep {metric}: forest {rc_forest:.4f} at 8000 ({qps:.0f} qps), "
            f"exact {rc_exact:.4f}, launches {json.dumps(moved)}")
    out = run_tool("compare_exact", [])
    grab(rf"forest: {NUM} qps  recall@5={NUM} \(search_k=1000\)", out)
    grab(rf"exact : {NUM} qps  recall@5=1\.0000", out)
    out = run_tool("fuzz", ["--seconds", "10"])
    assert grab(rf"done: {NUM} iterations in {NUM}s", out)[0] > 0 and "no invariant violations" in out
    # the tree count as built: without --n-trees the reference's formula
    # asks for ~630 trees at 262,144 x 768
    out = run_tool("build_only", ["--db", db, "--n-trees", str(N_TREES)])
    grab(rf"built in {NUM}s \(NOT committed\)", out)
    out = run_tool("upgrade", ["--db", db])
    assert out == f"all indexes already at {CURRENT_VERSION}\n", out
    part_done("a", t0, c0)

    # (b) 1.0.0 → 1.2.0 at 100,000 x 768: bit for bit on both engines
    t0, c0 = time.perf_counter(), counts()
    old = f"{tmp}/db_v1_0"
    with env("ARROY_TPU_NPY_STORE", "1"):
        wdb = Database(old)
        w = Writer(wdb, 0, D)
        with wdb.write() as wtxn:
            w.add_items(wtxn, np.arange(M_UPGRADE, dtype=np.uint32), x[:M_UPGRADE])
            w.builder(seed=42).n_trees(N_TREES).build(wtxn)
    answers = []
    for stage in ("before", "after"):
        odb = Database(old)
        r = Reader.open(odb.read(), 0, odb)
        r.assert_validity()
        st = odb.read().state(0)
        with open(f"{old}/idx_00000/gen_{st.generation:08d}/meta.json") as f:
            meta = json.load(f)
        say("upgrade", f"{stage}: version {r.version()}, store {meta.get('store', 'npy')}")
        if stage == "before":
            assert str(r.version()) == "1.0.0" and meta.get("store", "npy") == "npy", meta
        else:
            assert r.version() == CURRENT_VERSION and meta["store"] == "container", meta
        got = {}
        for engine in ("exact", "forest"):
            s = r.searcher(K, engine=engine)
            ids, d = s.device_fn(*s.prepare_queries(q))
            got[engine] = (s.route, ids.cpu().numpy(), d.cpu().numpy())
        answers.append(got)
        if stage == "before":
            out = run_tool("upgrade", ["--db", old])
            assert out == f"upgraded indexes [0] -> {CURRENT_VERSION}\n", out
    for engine, (route, ids, d) in answers[0].items():
        route2, ids2, d2 = answers[1][engine]
        assert route == route2 and np.array_equal(ids, ids2) and d.tobytes() == d2.tobytes(), engine
        say("upgrade", f"{engine} ({route}): the batch of {B_UPGRADE} answers bit for bit as "
            f"before the upgrade")
    assert answers[0]["exact"][0] == "fused_select" and answers[0]["forest"][0] == "traversal"
    part_done("b", t0, c0)

    # (c) a custom metric at 262,144 x 768, served through the probe
    t0, c0 = time.perf_counter(), counts()

    class HalfEuclidean(Euclidean):
        name = "half-euclidean"

    internals.register_metric(HalfEuclidean)
    half = f"{tmp}/db_half"
    hdb = Database(half)
    w = Writer(hdb, 0, D, metric="half-euclidean")
    with hdb.write() as wtxn:
        w.add_items(wtxn, np.arange(M_PROBE, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(N_TREES).build(wtxn)
    t_build = time.perf_counter() - t0
    hdb = Database(half)  # reopened from disk, the name resolves to the class
    hr = Reader.open(hdb.read(), 0, hdb, metric="half-euclidean")
    assert hr.metric is HalfEuclidean
    hr.assert_validity()
    same = same_forest(hr._state.forest, euc._state.forest)
    say("custom", f"half-euclidean: built in {t_build:.2f} s; forest equal to the euclidean "
        f"one node for node: {same}")
    assert same, "the grow read the metric's name"
    batches = [q[i:i + B_PROBE] for i in range(0, B_UPGRADE, B_PROBE)]
    ref_ids = run_batches(euc.searcher(K, engine="exact", precision="f32x1"), batches, "f32x1")[0]
    sk = SEARCH_K0
    for step in range(SK_DOUBLINGS + 1):
        s = hr.searcher(K, search_k=sk)
        assert s.engine == "forest" and s.route == "probe", (s.engine, s.route)
        ids, _ = run_batches(s, batches, f"half-euclidean sk={sk}")
        rc = recall_of(ids, ref_ids)
        say("custom", f"half-euclidean probe ({s.device_fn.tables.blk_rows.dtype} tables) "
            f"sk={sk}: recall@{K} vs f32x1 {rc:.4f}")
        if rc >= TARGET_RECALL or step == SK_DOUBLINGS:
            break
        sk *= 2
    assert rc >= TARGET_RECALL, f"custom metric recall {rc} < {TARGET_RECALL} at sk={sk}"
    rec["custom"] = {"search_k": sk, "recall": rc}
    del hr, hdb, s
    part_done("c", t0, c0)

    # (d) one exact batch inside the profiler: kernel 1 by name in the trace
    t0, c0 = time.perf_counter(), counts()
    odb = Database(old)
    s = Reader.open(odb.read(), 0, odb).searcher(K)
    dq = s.prepare_queries(q)
    s.device_fn(*dq)
    with profiling.trace(f"{tmp}/trace") as prof:
        s.device_fn(*dq)
    (name,) = os.listdir(f"{tmp}/trace")
    with open(f"{tmp}/trace/{name}") as f:
        text = f.read()
    hits = [e for e in prof.key_averages() if "fused_select_kernel" in e.key]
    named = sorted({e.key[:40] for e in prof.key_averages() if e.self_device_time_total > 0})
    assert "fused_select_kernel" in text and hits, f"the trace does not name kernel 1: {named}"
    say("profile", f"{name}: {len(text) / 1e6:.2f} MB; kernel 1 in it as "
        f"{hits[0].key[:60]!r}, {hits[0].count} call(s)")
    part_done("d", t0, c0)

    rec["phase10_s"] = time.perf_counter() - t_phase
    say("operator", json.dumps(rec))
    say("time", f"phase 10 took {rec['phase10_s']:.1f} s")
    return counts()


#: phase 11: shards on the one card, the sharded exact corpus and the
#: sharded forest's / mesh build's corpus (bench.py's model, seed 42)
N_SHARDS, M_SHARDED_FOREST = 4, 262_144
#: the sharded forest's search_k policy may double past phase 6's (each
#: shard searches a quarter of the budget)
SHARDED_SK_DOUBLINGS = 5


def multidevice_slice(rec):
    """Phase 11: the multi-device layer (`arroy_tpu_torch.parallel`) with
    `N_SHARDS` shards on the one card beside one shard.  Every kernel's
    counts are reset just before each part and read just after it; returns
    the phase's launches per kernel instance, summed over the parts."""
    import torch

    from arroy_tpu_torch import Database, Reader, Writer, entry, probe
    from arroy_tpu_torch.models import items
    from arroy_tpu_torch.ops import bq_kernels as bk, fused_select as fs, gather_score as gs
    from arroy_tpu_torch.parallel.forest import ShardedForestIndex
    from arroy_tpu_torch.parallel.mesh import ShardedExactIndex, _host_queries, make_mesh

    t_phase = time.perf_counter()
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    out = {}
    counters = (fs.launches, bk.launches, gs.launches)
    total = {k: 0 for c in counters for k in c}

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0

    def read(part):
        got = {k: n for c in counters for k, n in c.items()}
        for k, n in got.items():
            total[k] += n
        say("launches", f"multi-device path ({part}): {json.dumps(got)}")
        return got
    mesh, mesh1 = make_mesh(N_SHARDS), make_mesh(1)
    assert mesh.devices.size == N_SHARDS and all(d == torch.device("cuda", 0) for d in mesh.devices.flat)
    x = card_corpus(M_LARGE + BATCH * N_LARGE_BATCHES, D, 42)
    x, queries = x[:M_LARGE], x[M_LARGE:]
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(N_LARGE_BATCHES)]

    # (a) the sharded exact index over 1M x 768 against the single-device
    # f32x1 engine (phase 8's route), on the same batches
    def timed(fn, label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = [fn(b) for b in batches]
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        out[label] = dict(ms=ms, qps=BATCH / (ms / 1e3),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        say("multidevice", f"{label}: {json.dumps(out[label])}")
        return np.concatenate([i for i, _ in res]), np.concatenate([d for _, d in res])

    db = Database(None, device="cuda")
    w = Writer(db, 0, D)
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(M_LARGE, dtype=np.uint32), x)
        w.builder(seed=42).n_trees(1).build(wtxn)
    s = Reader.open(db.read(), 0, db).searcher(K, engine="exact", precision="f32x1")
    ref = timed(lambda b: tuple(a.cpu().numpy() for a in s.device_fn(*s.prepare_queries(b))),
                "f32x1 engine, 1 device")
    del s, db, w
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()
    reset()
    for n, m in ((N_SHARDS, mesh), (1, mesh1)):
        t0 = time.perf_counter()
        idx = ShardedExactIndex(m, x)
        say("multidevice", f"ShardedExactIndex {M_LARGE} x {D} on {n} shard(s): "
            f"{time.perf_counter() - t0:.2f} s to encode and place")
        got = timed(lambda b: idx.search(b, K), f"sharded exact {n} shard(s)")
        tie_aware_equal(*got, *ref, rtol=1e-5)
        say("multidevice", f"sharded exact {n} shard(s) equals the f32x1 engine on "
            f"{len(ref[0])} queries (tie-aware)")
        if n == N_SHARDS:
            cand = np.arange(0, M_LARGE, 3)
            fq = batches[0][:64]
            fids, fd = idx.search(fq, K, candidates=cand)
            assert bool(np.isin(fids, cand).all()), "a filtered id outside the candidates"
            x_f = torch.from_numpy(x[cand]).cuda()
            np.testing.assert_allclose(fd, brute_force_top(x_f, fq, K), rtol=1e-5)
            del x_f
            say("multidevice", f"filtered ({len(cand)} ids): 64 queries equal a float64 brute "
                f"force over the filter")
        del idx
        torch.cuda.empty_cache()
    read("a, euclidean")

    # BQ cosine: each shard's [2048 x 250,000] popcount matrix is kernel 2
    # (under the exact engine's 4 GiB matrix budget), counted from 0 here;
    # held against the single-device BQ exact engine (its scan, kernel 2 on
    # 262,144-row chunks) on the same batch, tie-aware
    metric = "binary quantized cosine"
    bq = ShardedExactIndex(mesh, x, metric=metric)
    reset()
    got = timed(lambda b: bq.search(b, K), f"sharded BQ {N_SHARDS} shards")
    bids, bd = bq.search(x[:BATCH], 1)
    launched = read("a, BQ")["bq_hamming"]
    assert launched >= N_SHARDS * (N_LARGE_BATCHES + 1), f"kernel 2 launched {launched} times"
    assert bool((bd[:, 0] == 0).all()), "a row that does not find itself at hamming 0"
    out["bq_self"] = float(np.mean(bids[:, 0] == np.arange(BATCH)))
    say("multidevice", f"BQ cosine {N_SHARDS} shards: kernel 2 launched {launched} times; every "
        f"one of {BATCH} rows finds a row at distance 0, its own id in {out['bq_self']:.4f} "
        f"(others share its sign bits)")
    with uncounted(*counters):
        db = Database(None, device="cuda")
        w = Writer(db, 0, D, metric=metric)
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(M_LARGE, dtype=np.uint32), x)
            w.builder(seed=42).n_trees(1).build(wtxn)
        s = Reader.open(db.read(), 0, db, metric=metric).searcher(K, engine="exact")
        ref_bq = [tuple(a.cpu().numpy() for a in s.device_fn(*s.prepare_queries(b))) for b in batches]
        tie_aware_equal(*got, *(np.concatenate(a) for a in zip(*ref_bq)), rtol=1e-6)
        say("multidevice", f"sharded BQ equals the single-device BQ exact engine ({s.route}) on "
            f"{len(got[0])} queries (distances to rtol 1e-6, tie-aware ids)")
        del s, db, w
        items._DEVICE_MIRROR.clear()
        # kernel 2 at the shape a shard gives it, bit-equal to its plain
        # version on shard 0's words against the first batch's
        qw = torch.from_numpy(_host_queries(bq.metric, batches[0], D)[0]).cuda()
        words = bq.shards[0].rows
        h = bk.bq_hamming_matrix(qw, words)
        assert torch.equal(h, bk.bq_hamming_matrix_reference(qw, words)), \
            "kernel 2 differs from its plain version on shard 0"
    rec["bq_hamming"]["phase11_check"] = {"shape": [int(qw.shape[0]), int(words.shape[0]),
                                                    int(words.shape[1])], "bit_equal": True}
    say("kernel2", f"bq_hamming on shard 0's words, B={qw.shape[0]} M={words.shape[0]} "
        f"w={words.shape[1]}: bit-equal to its plain version")
    del bq, qw, words, h
    torch.cuda.empty_cache()

    # (b) the sharded forest over 262,144 x 768: traversal and probe
    # fan-out under bench.py's search_k policy, kernel 3 counted
    xs = x[:M_SHARDED_FOREST]
    qb = [batches[0][i:i + B_PROBE] for i in range(0, 4 * B_PROBE, B_PROBE)]
    t0 = time.perf_counter()
    fidx = ShardedForestIndex.build(mesh, xs, n_trees=N_TREES, seed=42)
    torch.cuda.synchronize()
    say("multidevice", f"ShardedForestIndex.build {M_SHARDED_FOREST} x {D}, {N_SHARDS} shards x "
        f"{N_TREES} trees: {time.perf_counter() - t0:.2f} s")
    ref_ids = np.concatenate([ShardedExactIndex(mesh1, xs).search(b, K)[0] for b in qb])
    reset()
    for name, fn in (("traversal", fidx.search), ("probe", fidx.probe_search)):
        sk = SEARCH_K0
        for step in range(SHARDED_SK_DOUBLINGS + 1):
            fn(qb[0], K, search_k=sk)  # warm-up (the probe packs its tables)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = np.concatenate([fn(b, K, search_k=sk)[0] for b in qb])
            wall = time.perf_counter() - t0
            rc = recall_of(ids, ref_ids)
            row = dict(search_k=sk, recall=rc, qps=len(ids) / wall, ms=wall * 1e3 / len(qb))
            say("multidevice", f"sharded {name}: {json.dumps(row)}")
            if rc >= TARGET_RECALL or step == SHARDED_SK_DOUBLINGS:
                break
            sk *= 2
        out[f"sharded_{name}"] = row
        assert rc >= TARGET_RECALL, f"sharded {name} recall {rc} < {TARGET_RECALL} at sk={sk}"
    launched = read("b")["gather_score_bf16"]
    assert launched > 0, "kernel 3 never launched on the sharded probe"
    tables = fidx.enable_probe(dtype="bf16")
    t, sh = tables[0], fidx.shards[0]
    plan = fidx.probe_plan(K, out["sharded_probe"]["search_k"], tables, "bf16")
    qv = torch.from_numpy(qb[0]).cuda()
    bid = probe._rank_blocks(fidx.metric, plan["L"], t.nb_max, probe.block_scale(fidx.metric),
                             t.cent, t.caux, t.valid, qv).to(torch.int32).contiguous()
    with uncounted(gs.launches):
        err = check_gather(gs, t.blk_rows, bid, qv.to(torch.bfloat16).float().contiguous())
    rec["gather_score_bf16"]["phase11_check"] = {"max_abs_err": err, "shape": list(bid.shape),
                                                 "shard_items": sh.n_items}
    say("multidevice", f"kernel 3 on shard 0's tables ({sh.n_items} items, bid {list(bid.shape)}): "
        f"max |err| {err:.3g} against its plain version")
    del fidx, tables
    torch.cuda.empty_cache()

    # (c) one forest built on the mesh: equal to the 1-shard build node for
    # node, valid, and within 0.02 of the resident build's recall
    def build(m):
        db = Database(None, device="cuda")
        w = Writer(db, 0, D)
        with db.write() as wtxn:
            w.add_items(wtxn, np.arange(M_SHARDED_FOREST, dtype=np.uint32), xs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = w.builder(seed=42).n_trees(N_TREES)
            if m is not None:
                b.mesh(m)
            b.build(wtxn)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        return db, w, sec

    reset()
    built = {label: build(m) for label, m in (("mesh4", mesh), ("mesh1", mesh1), ("resident", None))}
    fa, fb = (built[k][0].read().state(0).forest for k in ("mesh4", "mesh1"))
    assert same_forest(fa, fb), "the 4-shard build differs from the 1-shard build"
    readers = {k: Reader.open(v[0].read(), 0, v[0]) for k, v in built.items()}
    for k in ("mesh4", "resident"):
        readers[k].assert_validity()
    say("multidevice", f"mesh builds of {M_SHARDED_FOREST} x {D}, {N_TREES} trees: 4 shards "
        f"{built['mesh4'][2]:.2f} s, 1 shard {built['mesh1'][2]:.2f} s, resident "
        f"{built['resident'][2]:.2f} s; the 4- and 1-shard forests equal node for node "
        f"({len(fa.leaves)} leaves); assert_validity ok")
    ex = readers["resident"].searcher(K, engine="exact", precision="f32x1")
    ref_b = np.concatenate([ex.device_fn(*ex.prepare_queries(b))[0][:, :K].cpu().numpy() for b in qb])
    rcs = {}
    for k in ("mesh4", "resident"):
        ids, _ = run_batches(readers[k].searcher(K, search_k=8000, engine="forest", traversal="xla"),
                             qb, f"{k} traversal sk=8000")
        rcs[k] = recall_of(ids[:, :K], ref_b)
    say("multidevice", f"traversal recall@{K} at search_k 8000: mesh {rcs['mesh4']:.4f}, "
        f"resident {rcs['resident']:.4f}")
    assert abs(rcs["mesh4"] - rcs["resident"]) <= 0.02, rcs
    out["mesh_build"] = dict(mesh4_s=built["mesh4"][2], mesh1_s=built["mesh1"][2],
                             resident_s=built["resident"][2], recall_mesh=rcs["mesh4"],
                             recall_resident=rcs["resident"])
    db, w, _ = built["mesh4"]
    n_upd = M_SHARDED_FOREST // 100
    with db.write() as wtxn:
        w.del_items(wtxn, np.arange(n_upd, dtype=np.uint32))
        w.add_items(wtxn, np.arange(M_SHARDED_FOREST, M_SHARDED_FOREST + n_upd, dtype=np.uint32),
                    x[M_SHARDED_FOREST:M_SHARDED_FOREST + n_upd])
        t0 = time.perf_counter()
        w.builder(seed=43).n_trees(N_TREES).mesh(mesh).build(wtxn)
        torch.cuda.synchronize()
        out["mesh_build"]["update_s"] = time.perf_counter() - t0
    r = Reader.open(db.read(), 0, db)
    r.assert_validity()
    assert r.n_items() == M_SHARDED_FOREST and not r.contains_item(0)
    assert r.nns(1).search_k(20_000).by_item(M_SHARDED_FOREST)[0][0] == M_SHARDED_FOREST
    say("multidevice", f"1% update on the mesh ({n_upd} deleted, {n_upd} added): "
        f"{out['mesh_build']['update_s']:.2f} s, assert_validity ok")
    del built, readers, db, w, r
    items._DEVICE_MIRROR.clear()
    torch.cuda.empty_cache()

    # (d) the five checks of __graft_entry__.dryrun_multichip on the port
    t0 = time.perf_counter()
    entry.dryrun_multichip(N_SHARDS)
    say("multidevice", f"dryrun_multichip({N_SHARDS}) passed in {time.perf_counter() - t0:.1f} s")
    read("c-d")
    out["phase11_s"] = time.perf_counter() - t_phase
    say("multidevice", json.dumps(out))
    say("time", f"phase 11 took {out['phase11_s']:.1f} s")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from arroy_tpu_torch.ops import _build, bq_kernels as bk, fused_select as fs, gather_score as gs

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(_build.build, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        _build.load(name)
    say("build", f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        with open(f"{_build.BUILD_DIR}/{name}.log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say("build", f"{name}: {line.strip()}")
    # kernel 1 must run on the tensor cores: wgmma in both instances' SASS
    mma_ops = {}
    for fn, ops in tensor_core_ops(f"{_build.BUILD_DIR}/libfused_select.so").items():
        inst = "fused_select_int8" if "ILb1E" in fn else "fused_select_bf16"
        mma_ops[inst] = ops
    say("build", f"fused_select tensor-core instructions in SASS: {json.dumps(mma_ops)}")
    for inst in ("fused_select_int8", "fused_select_bf16"):
        assert sum(mma_ops.get(inst, {}).values()) > 0, f"{inst} has no tensor-core instruction"
    # kernel 2 must count on the tensor cores: one-bit MMAs in its SASS
    ham_ops = {}
    for ops in tensor_core_ops(f"{_build.BUILD_DIR}/libhamming.so").values():
        for op, n in ops.items():
            ham_ops[op] = ham_ops.get(op, 0) + n
    say("build", f"hamming tensor-core instructions in SASS: {json.dumps(ham_ops)}")
    assert ham_ops.get("BMMA", 0) + ham_ops.get("IMMA", 0) > 0, "bq_hamming has no tensor-core instruction"
    mma_ops["bq_hamming"] = ham_ops

    # 3. kernel parity
    rec = {
        "fused_select_int8": dict(source="arroy_tpu_torch/csrc/fused_select.cu",
                                  replaces="arroy_tpu/ops/pallas_exact.py:120"),
        "fused_select_bf16": dict(source="arroy_tpu_torch/csrc/fused_select.cu",
                                  replaces="arroy_tpu/ops/pallas_exact.py:120"),
        "bq_hamming": dict(source="arroy_tpu_torch/csrc/hamming.cu",
                           replaces="arroy_tpu/ops/pallas_kernels.py:38"),
    }
    for kind in ("bf16", "int8", "f32"):
        rec[f"gather_score_{kind}"] = dict(source="arroy_tpu_torch/csrc/gather_score.cu",
                                           replaces="arroy_tpu/ops/pallas_probe.py:75")
    for inst, ops in mma_ops.items():
        rec[inst]["tensor_core_ops"] = ops
    kernel_parity(dev, rec)
    say("time", f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    # 4-5. the exact slice (main path: counts from here)
    rng = np.random.default_rng(42)
    x = make_corpus(rng, M + BATCH * N_BATCHES, D)
    x, queries = x[:M], x[M:]
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(N_BATCHES)]
    for k in fs.launches:
        fs.launches[k] = 0
    bk.launches["bq_hamming"] = 0
    with tempfile.TemporaryDirectory() as tmp:
        exact_slice(tmp, x, queries, batches)
    launches = {**dict(fs.launches), **dict(bk.launches)}
    say("launches", f"exact path: {json.dumps(launches)}")
    say("time", f"phases 4-5 done at {time.perf_counter() - t_start:.1f} s")
    del x, queries, batches

    # 6. the probe slice (main path: counts from here)
    for k in gs.launches:
        gs.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        served, pbatches = probe_slice(tmp)
        probe_launches = dict(gs.launches)
        say("launches", f"probe path: {json.dumps(probe_launches)}")
        say("probe", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        time_gather(gs, served, pbatches, rec)
        del served
    launches.update(probe_launches)
    say("time", f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # 8. large-corpus exact serving (its own path: counts from here)
    for k in fs.launches:
        fs.launches[k] = 0
    bk.launches["bq_hamming"] = 0
    large_launches, base, queries = large_slice(rec)
    say("launches", f"large-corpus path: {json.dumps(large_launches)}")
    for name, n in large_launches.items():
        assert n > 0, f"{name} never launched on the large-corpus path"
        rec[name]["phase8_launches"] = n
    say("time", f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # 9. the incremental build on phase 8's euclidean index (no kernel of
    # its own: routing and the grow are plain PyTorch, so no count moves)
    counters = (fs.launches, bk.launches, gs.launches)
    with uncounted(*counters):
        for c in counters:
            for k in c:
                c[k] = 0
        incremental_slice(base, queries)
        say("launches", f"incremental path: {json.dumps({k: v for c in counters for k, v in c.items()})}")
    del base, queries
    say("time", f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # 10. the operator surface (its own path: counts from here)
    for c in counters:
        for k in c:
            c[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        p10 = operator_slice(tmp)
    say("launches", f"operator path: {json.dumps(p10)}")
    for name in rec:
        rec[name]["phase10_launches"] = p10[name]
    for kernel in ("fused_select", "bq_hamming", "gather_score"):
        assert sum(n for k, n in p10.items() if k.startswith(kernel)) > 0, \
            f"{kernel} never launched on the operator path"
    say("time", f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # 11. the multi-device layer on the one card (counts from 0 a part)
    p11 = multidevice_slice(rec)
    say("launches", f"multi-device path: {json.dumps(p11)}")
    for name in rec:
        rec[name]["phase11_launches"] = p11[name]
    say("time", f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on its main path"
        rec[name]["launches"] = n

    kernels = [{"name": n, "route": "cuda", **r} for n, r in rec.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
