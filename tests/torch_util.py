"""Helpers shared by the PyTorch port's tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (its kernel wrappers then use their plain PyTorch
versions) and the JAX package runs as its own tests run it on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# several xdist workers share the host: keep each one single-threaded
torch.set_num_threads(1)


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device is present (decided at
    run time, never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU mode")
    return torch.device("cuda")


def query_arrays(metric, vectors: np.ndarray):
    """(qv, qn, qe, qf) host arrays exactly as both searchers prepare them."""
    qv = metric.encode_np(np.asarray(vectors, np.float32))
    qn = metric.item_norms_np(qv, vectors.shape[1])
    n = len(qv)
    qe = np.zeros(n, np.float32)
    qf = np.zeros(n, np.float32) if metric.has_extra else np.ones(n, np.float32)
    return qv, qn, qe, qf


def to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy → tensor; uint32 packed words become int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def dots_epilogue(blk_rows: torch.Tensor):
    """Kernel 3's epilogue whose scores are the dots themselves: the "dot"
    op, every slot live, no scale, no filter."""
    from arroy_tpu_torch.ops.gather_score import Epilogue

    nbt, p, _ = blk_rows.shape
    dev = blk_rows.device
    return Epilogue("dot", torch.zeros((nbt, p), device=dev),
                    torch.arange(nbt * p, dtype=torch.int32, device=dev).view(nbt, p))


def tie_aware_equal(ids_a, d_a, ids_b, d_b, rtol=1e-6, atol=0.0):
    """Sorted distance rows agree within the tolerance, and ids are equal
    wherever a distance is strictly unique (within the tolerance) in the
    row's top-k: equal distances may come back in any order, and the
    row's largest distance may tie with items past k (a boundary tie)."""
    ids_a, d_a = np.asarray(ids_a), np.asarray(d_a, np.float64)
    ids_b, d_b = np.asarray(ids_b), np.asarray(d_b, np.float64)
    assert ids_a.shape == ids_b.shape
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        np.testing.assert_allclose(np.sort(da), np.sort(db), rtol=rtol, atol=atol)
        top = np.nanmax(da) if np.isfinite(da).any() else np.nan
        for j in range(len(da)):
            near = np.isclose(da, da[j], rtol=rtol, atol=atol)
            if near.sum() == 1 and not np.isclose(da[j], top, rtol=rtol, atol=atol):
                assert ia[j] == ib[j], f"ids differ at a unique distance: {ia} vs {ib}"


def recall(got_ids: np.ndarray, ref_ids: np.ndarray) -> float:
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got_ids, ref_ids))
    return hits / max(np.asarray(ref_ids).size, 1)


def assert_forests_equal(fa, fb, rtol=1e-5, atol=1e-6):
    """Two forests node for node: node ids, kinds, children, plane rows,
    leaves and roots bit-equal; split planes and offsets equal to ``rtol`` (``atol``
    its floor), since f32 arithmetic in another order differs in the last
    bits; packed BQ planes bit-equal."""
    used = np.asarray(sorted(int(i) for i in fa.used_node_ids()), np.int64)
    np.testing.assert_array_equal(used, sorted(int(i) for i in fb.used_node_ids()))
    for key in ("kind", "left", "right", "ptr"):
        np.testing.assert_array_equal(getattr(fa, key)[used], getattr(fb, key)[used], err_msg=key)
    if np.issubdtype(np.asarray(fa.normals).dtype, np.integer):
        np.testing.assert_array_equal(fa.normals, fb.normals)
    else:
        np.testing.assert_allclose(fa.normals, fb.normals, rtol=rtol, atol=atol)
    np.testing.assert_allclose(fa.aux, fb.aux, rtol=rtol, atol=atol)
    assert set(fa.leaves) == set(fb.leaves)
    for k in fa.leaves:
        np.testing.assert_array_equal(fa.leaves[k], fb.leaves[k])
    assert list(fa.roots) == list(fb.roots)
