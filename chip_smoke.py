#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`arroy_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and the script
exits non-zero:

1. device — requires CUDA (never runs on the CPU); prints the card's name
   and power limit as nvidia-smi reports them;
2. build — compiles the hand-written kernels from `arroy_tpu_torch/csrc/`;
3. kernel parity — each kernel against its plain PyTorch version on the
   card, at edge-straddling shapes and at the main path's shapes, where
   both are also timed with CUDA events;
4. slice — the bench configuration (100,000 x 768 clustered corpus,
   euclidean, 10 trees): add, build, commit to disk, reopen, validate,
   then exact search at f32x1 / bf16 / int8 on 4 batches of 2048
   queries, with recall and brute-force checks;
5. BQ slice — the same corpus under "binary quantized cosine", checked
   tie-aware against the same engine run on the CPU (plain versions).

Kernel launch counts are reset right before phase 4 and read right after
phase 5: every kernel must have launched on the main path.  The last
lines are the per-kernel JSON record, the nvidia-smi line and the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

M, D, N_TREES, K, BATCH, N_BATCHES = 100_000, 768, 10, 10, 2048, 4


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


def check_select(fs, inputs, int8):
    """Kernel vs plain version; returns max |Δkey| (key units).  int8 keys
    and indices must be equal; bf16 (f32 sums in another order) within
    one value quantum, >= 98% of keys equal, indices equal where keys are."""
    import torch

    keys, idx = fs.fused_block_select(*inputs)
    rkeys, ridx = fs.fused_block_select_reference(*inputs)
    torch.cuda.synchronize()
    dk = (keys.long() - rkeys.long()).abs()
    eq = dk == 0
    if int8:
        assert bool(eq.all()) and torch.equal(idx, ridx), "int8 select differs"
    else:
        assert int(dk.max()) <= 2 * fs.DEFAULT_BM, f"bf16 keys differ by {int(dk.max())}"
        frac = float(eq.float().mean())
        assert frac >= 0.98, f"only {frac:.4f} of bf16 keys equal"
        assert torch.equal(idx[eq], ridx[eq]), "bf16 indices differ at equal keys"
    return int(dk.max())


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


def tie_aware_equal(ids_a, d_a, ids_b, d_b):
    """Sorted distance rows equal; ids equal wherever the distance is
    strictly unique within the row's top-k.  The row's largest distance
    may tie with items past k (a boundary tie), so it is exempt."""
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        np.testing.assert_array_equal(np.sort(da), np.sort(db))
        for j in range(len(da)):
            if np.sum(da == da[j]) == 1 and da[j] != da.max():
                assert ia[j] == ib[j], f"id differs at a unique distance: {ia} vs {ib}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from arroy_tpu_torch import Database, Reader, Writer
    from arroy_tpu_torch.device import DeviceIndex
    from arroy_tpu_torch.ops import _build, bq_kernels as bk, fused_select as fs
    from arroy_tpu_torch.search import make_exact_fn

    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    for name in ("fused_select", "hamming"):
        _build.load(name)
    say("build", f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in ("fused_select", "hamming"):
        with open(f"{_build.BUILD_DIR}/{name}.log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say("build", f"{name}: {line.strip()}")

    # 3. kernel parity (+ timing at the main path's shapes)
    rng = np.random.default_rng(0)
    rec = {
        "fused_select_int8": dict(source="arroy_tpu_torch/csrc/fused_select.cu",
                                  replaces="arroy_tpu/ops/pallas_exact.py:120"),
        "fused_select_bf16": dict(source="arroy_tpu_torch/csrc/fused_select.cu",
                                  replaces="arroy_tpu/ops/pallas_exact.py:120"),
        "bq_hamming": dict(source="arroy_tpu_torch/csrc/hamming.cu",
                           replaces="arroy_tpu/ops/pallas_kernels.py:38"),
    }
    for name, int8 in (("fused_select_int8", True), ("fused_select_bf16", False)):
        err = 0
        for b, mp in ((256, 32768), (BATCH, 100_352)):
            inputs = select_inputs(rng, b, mp, D, int8, dev)
            err = max(err, check_select(fs, inputs, int8))
            say("parity", f"{name} B={b} Mp={mp} d={D}: max |dkey| {err}")
        rec[name]["max_abs_err"] = err
        rec[name]["ms"] = cuda_ms(lambda: fs.fused_block_select(*inputs), 10)
        rec[name]["plain_ms"] = cuda_ms(lambda: fs.fused_block_select_reference(*inputs), 3)
        del inputs
    err = 0
    for b, m in ((130, 1537), (BATCH, M)):
        qw = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 24), dtype=np.int64).astype(np.int32)).to(dev)
        xw = torch.from_numpy(rng.integers(-2**31, 2**31, (m, 24), dtype=np.int64).astype(np.int32)).to(dev)
        h = bk.bq_hamming_matrix(qw, xw)
        hr = bk.bq_hamming_matrix_reference(qw, xw)
        assert torch.equal(h, hr), "hamming kernel differs from its plain version"
        err = max(err, int((h - hr).abs().max()))
        say("parity", f"bq_hamming B={b} M={m} w=24: bit-equal")
    rec["bq_hamming"]["max_abs_err"] = err
    rec["bq_hamming"]["ms"] = cuda_ms(lambda: bk.bq_hamming_matrix(qw, xw), 10)
    rec["bq_hamming"]["plain_ms"] = cuda_ms(lambda: bk.bq_hamming_matrix_reference(qw, xw), 3)
    del qw, xw, h, hr
    for name, r in rec.items():
        say("parity", f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")

    # 4. the slice at the bench configuration (main path: counts from here)
    rng = np.random.default_rng(42)
    x = make_corpus(rng, M + BATCH * N_BATCHES, D)
    x, queries = x[:M], x[M:]
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(N_BATCHES)]
    for k in fs.launches:
        fs.launches[k] = 0
    bk.launches["bq_hamming"] = 0
    with tempfile.TemporaryDirectory() as tmp:
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
            hits = sum(len(set(a) & set(b)) for a, b in zip(outs[prec][0], ref_ids))
            rc = hits / ref_ids.size
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
    launches = {**dict(fs.launches), **dict(bk.launches)}
    say("launches", json.dumps(launches))
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
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
