"""The plain reference: exact top-k and exact distances in float64, in
plain PyTorch, from the vectors the benchmark made.  It imports nothing of
the program and takes nothing the program made.

Distances are arroy's, as functions of the dot product and the two
squared norms:

- ``cosine``: ``(1 - cos) / 2`` with ``cos`` clamped to [-1, 1] (0 where
  a norm is 0);
- ``euclidean``: ``sqrt(max(|x|^2 + |q|^2 - 2 x.q, 0))``;
- ``dot-product``: ``-x.q``.

``precision="tf32"`` is the control: the same computation with both
inputs rounded to TF32 (10 mantissa bits, round to nearest even) and
float32 arithmetic, the precision a float32 matrix product takes on the
card's tensor cores when TF32 is on.
"""

from __future__ import annotations

import torch

METRICS = ("cosine", "euclidean", "dot-product")
#: rows of the corpus and of the queries in one block of the top-k
ITEM_BLOCK, QUERY_BLOCK = 131_072, 2048


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest even)."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _prep(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return t.to(torch.float64)
    if precision == "tf32":
        return tf32(t)
    raise ValueError(f"unknown precision {precision!r}")


def distance(metric: str, dots, xx, qq):
    """arroy's distance from dot products and squared norms (broadcast)."""
    if metric == "cosine":
        den = torch.sqrt(xx * qq)
        ok = den > 0
        cos = torch.clamp(dots / torch.where(ok, den, torch.ones_like(den)), -1.0, 1.0)
        return torch.where(ok, (1.0 - cos) / 2.0, torch.zeros_like(cos))
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(xx + qq - 2.0 * dots, min=0.0))
    if metric == "dot-product":
        return -dots
    raise ValueError(f"no reference for metric {metric!r}")


def topk(x, q, k: int, metric: str, precision: str = "f64", allowed=None):
    """The k nearest rows of `x` to each row of `q` (both float32 tensors on
    one device), ascending by distance: (ids [nq, k] int64, distances
    [nq, k] in the precision's type).  `allowed` ([n] bool) keeps only
    those rows."""
    n = x.shape[0]
    best_d, best_i = [], []
    for q0 in range(0, q.shape[0], QUERY_BLOCK):
        qb = _prep(q[q0:q0 + QUERY_BLOCK], precision)
        qq = (qb * qb).sum(1)[:, None]
        d_run = i_run = None
        for x0 in range(0, n, ITEM_BLOCK):
            xb = _prep(x[x0:x0 + ITEM_BLOCK], precision)
            xx = (xb * xb).sum(1)[None, :]
            d = distance(metric, qb @ xb.T, xx, qq)
            if allowed is not None:
                d = torch.where(allowed[None, x0:x0 + len(xb)], d, torch.full_like(d, float("inf")))
            kk = min(k, d.shape[1])
            dv, di = torch.topk(d, kk, dim=1, largest=False)
            di = di + x0
            if d_run is not None:
                dv, j = torch.topk(torch.cat([d_run, dv], 1), k, dim=1, largest=False)
                di = torch.gather(torch.cat([i_run, di], 1), 1, j)
            elif kk < k:
                raise ValueError(f"fewer than {k} rows")
            d_run, i_run = dv, di
        best_d.append(d_run)
        best_i.append(i_run)
    return torch.cat(best_i), torch.cat(best_d)


def pair_distances(x, q, qidx, ids, metric: str, block: int = 1 << 18):
    """float64 distance of query ``q[qidx[j]]`` to row ``x[ids[j]]`` for
    every j (1-D int64 tensors on the vectors' device)."""
    out = torch.empty(len(ids), dtype=torch.float64, device=x.device)
    for s in range(0, len(ids), block):
        xb = x[ids[s:s + block]].to(torch.float64)
        qb = q[qidx[s:s + block]].to(torch.float64)
        out[s:s + block] = distance(
            metric, (xb * qb).sum(1), (xb * xb).sum(1), (qb * qb).sum(1)
        )
    return out
