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
   CPU; then kernel 3 timed on a real selection of blocks, with the
   share of distinct blocks in the whole selection and in the probe's
   chunks of it, and its rates on total, distinct and read bytes.

Kernel launch counts are reset right before each main path (phases 4-5,
and phase 6) and read right after it: every kernel of that path must have
launched there.  The last lines are the per-kernel JSON record, the
nvidia-smi line and the result.
"""

from __future__ import annotations

import json
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


def check_select(fs, inputs, int8, bm):
    """Kernel vs plain version; returns (max |Δkey| in key units, share of
    keys equal).  int8 keys and indices must be equal; bf16 (f32 sums in
    another order) within one value quantum, >= 98% of keys equal,
    indices equal where keys are."""
    import torch

    keys, idx = fs.fused_block_select(*inputs, bm=bm)
    rkeys, ridx = fs.fused_block_select_reference(*inputs, bm=bm)
    torch.cuda.synchronize()
    dk = (keys.long() - rkeys.long()).abs()
    eq = dk == 0
    frac = float(eq.float().mean())
    if int8:
        assert bool(eq.all()) and torch.equal(idx, ridx), "int8 select differs"
    else:
        assert int(dk.max()) <= 2 * bm, f"bf16 keys differ by {int(dk.max())}"
        assert frac >= 0.98, f"only {frac:.4f} of bf16 keys equal"
        assert torch.equal(idx[eq], ridx[eq]), "bf16 indices differ at equal keys"
    return int(dk.max()), frac


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


def run_batches(s, batches, label):
    """Warm up, then time the searcher over every batch with CUDA events;
    returns the concatenated (ids, dists) on the host."""
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
    return (
        np.concatenate([i.cpu().numpy() for i, _ in res]),
        np.concatenate([d.cpu().numpy() for _, d in res]),
    )


def recall_of(ids, ref_ids):
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids, ref_ids))
    return hits / ref_ids.size


def tie_aware_equal(ids_a, d_a, ids_b, d_b):
    """Sorted distance rows equal; ids equal wherever the distance is
    strictly unique within the row's top-k.  The row's largest distance
    may tie with items past k (a boundary tie), so it is exempt."""
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        np.testing.assert_array_equal(np.sort(da), np.sort(db))
        for j in range(len(da)):
            if np.sum(da == da[j]) == 1 and da[j] != da.max():
                assert ia[j] == ib[j], f"id differs at a unique distance: {ia} vs {ib}"


def probe_agree(ids_a, d_a, ids_b, d_b):
    """The card's probe against the CPU's: at most 1 differing id per row
    (a bf16 summation-order swap at the k2 cut); rows with the same ids
    have sorted distances equal at rtol 1e-5, and every shared id its
    distance.  Returns the number of differing ids."""
    n_diff = 0
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        diff = len(ia) - len(set(ia.tolist()) & set(ib.tolist()))
        assert diff <= 1, f"{diff} ids differ in one row: {ia} vs {ib}"
        n_diff += diff
        if diff == 0:
            np.testing.assert_allclose(np.sort(da), np.sort(db), rtol=1e-5)
        where = {int(i): float(v) for i, v in zip(ib, db)}
        for i, v in zip(ia, da):
            if int(i) in where:
                np.testing.assert_allclose(v, where[int(i)], rtol=1e-5)
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
            e, frac = check_select(fs, inputs, int8, bm)
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
    """Phases 4-5: the exact engine (kernels 1 and 2)."""
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
    return served, batches


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
