"""The plain reference equals a brute force in numpy at tiny sizes, and
imports nothing of the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import reference, spec


def _brute(x, q, metric):
    x, q = x.astype(np.float64), q.astype(np.float64)
    dots = q @ x.T
    xx, qq = (x * x).sum(1)[None, :], (q * q).sum(1)[:, None]
    if metric == "cosine":
        return (1.0 - np.clip(dots / np.sqrt(xx * qq), -1, 1)) / 2.0
    if metric == "euclidean":
        return np.sqrt(np.maximum(xx + qq - 2 * dots, 0))
    return -dots


@pytest.mark.parametrize("metric", reference.METRICS)
@pytest.mark.parametrize("filtered", [False, True])
def test_topk_equals_brute_force(metric, filtered, monkeypatch):
    monkeypatch.setattr(reference, "ITEM_BLOCK", 97)  # several blocks, the last ragged
    monkeypatch.setattr(reference, "QUERY_BLOCK", 13)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    d = _brute(x, q, metric)
    allowed = None
    if filtered:
        keep = rng.random(500) < 0.3
        d = np.where(keep[None, :], d, np.inf)
        allowed = torch.from_numpy(keep)
    ids, dist = reference.topk(torch.from_numpy(x), torch.from_numpy(q), 10, metric, "f64", allowed)
    np.testing.assert_array_equal(ids.numpy(), np.argsort(d, axis=1, kind="stable")[:, :10])
    np.testing.assert_allclose(dist.numpy(), np.sort(d, axis=1)[:, :10], rtol=1e-12, atol=1e-12)
    pairs = reference.pair_distances(torch.from_numpy(x), torch.from_numpy(q),
                                     torch.arange(40).repeat_interleave(10), ids.reshape(-1), metric)
    np.testing.assert_allclose(pairs.numpy().reshape(40, 10), dist.numpy(), rtol=1e-12, atol=1e-12)


def test_tf32_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0e-5])
    out = reference.tf32(v)
    assert out[0] == 1.0 + 2**-10       # representable
    assert out[1] == 1.0                # a tie rounds to even
    assert out[2] == 1.0 + 2**-9        # a tie rounds to even
    assert out[3] == 1.0
    bits = out.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0


def test_the_reference_imports_nothing_of_the_program():
    for mod in ("reference.py", "data.py", "checks.py", "kernels.py"):
        with open(os.path.join(spec.HERE, mod)) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {n.partition(".")[0] for n in names} & {"arroy_tpu_torch", "arroy_tpu", "jax"}, mod
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference, benchmark.checks, "
            "benchmark.data; print(sorted(m for m in sys.modules if m.partition('.')[0] in "
            "('arroy_tpu_torch', 'arroy_tpu', 'jax')))" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
