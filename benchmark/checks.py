"""The comparison that decides ``correct``.

Every answer of every request in the window is judged, once the window
has closed and the program's state is freed, against the plain reference
(`reference.py`) worked out from the vectors the benchmark made:

- ``recall10``: the share of the answers' ids that are among the
  reference's exact top-k of their query.  Its limit is the recall the
  cell states (the target its ``search_k`` was chosen for).
- ``dist_err``: the widest gap between a returned distance and the
  float64 distance of that query to the vector handed in under the
  returned id.  It holds the store (ids map to the vectors that were
  added) and the exact re-score of every engine.
- ``bad_answers``: answers that break what the API guarantees: an id that
  is not an item (or not in the request's filter), an id twice in one
  answer, a distance that is not finite or is smaller than the one before
  it.  Its limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

#: answer rows uploaded and judged at a time
ROWS = 1 << 19


def judge(answers, schedule, x, pool, metric: str, k: int, limits: dict, allowed=None,
          device="cuda") -> dict:
    """{name: {"value", "limit", "ok"}} for the numbers compared.

    `answers`: (schedule position, ids [B, k], dists [B, k]) per request;
    `schedule`: [S, B] pool indices; `x`, `pool`: the corpus and query
    pool (host f32); `allowed`: the filter's item ids, or None."""
    xd = torch.from_numpy(x).to(device)
    qd = torch.from_numpy(pool).to(device)
    n = x.shape[0]
    mask = None
    if allowed is not None:
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        mask[torch.from_numpy(allowed).to(device)] = True
    ref_ids, _ = reference.topk(xd, qd, k, metric, "f64", mask)

    ids = np.concatenate([a[1] for a in answers]) if answers else np.zeros((0, k), np.int64)
    dists = np.concatenate([a[2] for a in answers]) if answers else np.zeros((0, k), np.float32)
    qidx = np.concatenate([schedule[a[0] % len(schedule)] for a in answers]) if answers \
        else np.zeros(0, np.int64)
    hits = bad = 0
    err = 0.0
    for s in range(0, len(ids), ROWS):
        i = torch.from_numpy(np.ascontiguousarray(ids[s:s + ROWS])).to(device).to(torch.int64)
        d = torch.from_numpy(np.ascontiguousarray(dists[s:s + ROWS])).to(device)
        q = torch.from_numpy(qidx[s:s + ROWS]).to(device).to(torch.int64)
        valid = (i >= 0) & (i < n)
        ic = torch.where(valid, i, torch.zeros_like(i))
        if mask is not None:
            valid &= mask[ic]
        srt = torch.sort(i, dim=1).values
        twice = torch.zeros_like(valid)
        twice[:, 1:] = srt[:, 1:] == srt[:, :-1]
        finite = torch.isfinite(d)
        order = torch.ones_like(valid)
        order[:, 1:] = d[:, 1:] >= d[:, :-1]
        bad += int((~valid | ~finite | ~order).sum()) + int(twice.sum())
        hits += int((i[:, :, None] == ref_ids[q][:, None, :]).any(2).sum())
        true = reference.pair_distances(
            xd, qd, q[:, None].expand_as(ic).reshape(-1), ic.reshape(-1), metric
        ).view_as(d)
        gap = torch.where(valid & finite, (d.double() - true).abs(), torch.zeros_like(true))
        err = max(err, float(gap.max()) if gap.numel() else 0.0)
    recall = hits / max(ids.size, 1)
    out = {
        "recall10": {"value": recall, "limit": limits["recall10_min"], "ok": recall >= limits["recall10_min"]},
        "dist_err": {"value": err, "limit": limits["dist_err_max"], "ok": err <= limits["dist_err_max"]},
        "bad_answers": {"value": bad, "limit": 0, "ok": bad == 0},
    }
    return out
