"""Multi-device scale-out over a list of torch devices.

Counterpart of `arroy_tpu/parallel/mesh.py`.  The JAX package's mesh is
single-controller: one process drives every device through `shard_map`.
The port's counterpart is the same in one process: a `Mesh` is an
ordered list of devices, shard s lives on ``mesh.devices[s]``, every
shard's work is issued from the host in turn, and each cross-shard
collective becomes a plain gather onto ``devices[0]``:

* search: per-shard top-k → gather of n·k values per query → one `topk`;
* build: per-shard margins, with per-segment counts summed on the host
  side of the gather.

Several shards may share one device (the JAX tests' virtual CPU mesh
does the same), so the whole layer runs, and is checked, on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..metrics import resolve_metric
from ..search import (
    _MATMUL_METRICS,
    _exact_batch,
    _exact_bq_matrix,
    _exact_bq_scan,
    _exact_f32_direct,
    _exact_scan,
    _row_sq,
    _scan_chunk,
    _streams,
)

AXIS = "shard"
_INF = float("inf")


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one shard each (repeats allowed).

    ``devices`` is a 1-d numpy object array, so ``mesh.devices.size`` is
    the shard count and ``mesh.devices.flat`` walks them, as on the JAX
    package's `jax.sharding.Mesh`."""

    devices: np.ndarray


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards on ``device``.

    On ``cuda`` with no index the shards go round-robin over the visible
    cards (no count: one shard per card; more shards than cards share
    them); a device with an index, or ``cpu``, holds every shard (no
    count: one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        n = cards if n_devices is None else int(n_devices)
        devs = [torch.device("cuda", s % cards) for s in range(n)]
    else:
        devs = [device] * (1 if n_devices is None else int(n_devices))
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr)


def merge_topk(metric, dims: int, count: int, parts, device):
    """The cross-shard merge: each shard's (ids [B, k_s], raw distances),
    +inf where dead, gathered onto ``device``; the best ``count`` by raw
    distance (ascending is better for every metric), normalized, NaN where
    dead (a dead slot's id is a legal item id, so the distance is the only
    tell)."""
    all_ids = torch.cat([i.to(device) for i, _ in parts], dim=1)
    all_d = torch.cat([d.to(device) for _, d in parts], dim=1)
    kfin = min(count, all_d.shape[1])
    out_d, pos = torch.topk(all_d, kfin, dim=1, largest=False)
    out_ids = torch.gather(all_ids, 1, pos)
    out_d = torch.where(out_d < _INF, metric.normalized_distance(out_d, dims), float("nan"))
    return out_ids, out_d


def _host_queries(metric, queries, dims: int):
    qv = metric.encode_np(np.asarray(queries, np.float32))
    qn = metric.item_norms_np(qv, dims)
    if qv.dtype == np.uint32:
        qv = qv.view(np.int32)
    return qv, qn


# ---------------------------------------------------------------------------
# sharded exact search
# ---------------------------------------------------------------------------


class _ExactShard:
    """One shard's rows, on its device."""

    def __init__(self, metric, rows, norms, live, ids, device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.device = device
        self.rows = t(rows.view(np.int32) if rows.dtype == np.uint32 else rows)
        self.norms = t(norms)
        self.extras = torch.zeros_like(self.norms)
        self.live_np, self.ids_np = live, ids
        self.live = t(live)
        self.ids = t(ids.astype(np.int64))
        self.x2 = _row_sq(self.rows) if metric.name == "euclidean" else self.norms

    def topk(self, metric, dims, k, live, qv, qn):
        """This shard's top-k on raw distances: the exact engine's f32x1
        route (its matmul or scan, a cut, the exact re-score) for the
        dot-decomposable metrics, the popcount distances for BQ (kernel 2
        on a card), the per-pair formula otherwise."""
        b, m = int(qv.shape[0]), int(self.rows.shape[0])
        kk = min(k, m)
        qe = torch.zeros_like(qn)
        if metric.binary:
            if _streams(b, m):
                return _exact_bq_scan(metric, dims, kk, _scan_chunk(b), self.rows, self.norms,
                                      self.ids, live, qv, qn, normalize=False)
            return _exact_bq_matrix(metric, dims, kk, self.rows, self.norms, self.ids, live,
                                    qv, qn, normalize=False)
        if metric.name in _MATMUL_METRICS:
            if _streams(b, m):
                return _exact_scan(metric, dims, kk, _scan_chunk(b), self.rows, self.x2, self.rows,
                                   self.norms, self.extras, self.ids, live, qv, qn, qe,
                                   normalize=False)
            return _exact_f32_direct(metric, dims, kk, self.x2, self.rows, self.norms, self.extras,
                                     self.ids, live, qv, qn, qe, normalize=False)
        return _exact_batch(metric, dims, kk, self.rows, self.norms, self.extras, self.ids, live,
                            qv, qn, qe, normalize=False)


class ShardedExactIndex:
    """Corpus-sharded brute-force index: per-shard top-k + one merge.

    Rows are split contiguously into ``mesh.devices.size`` equal shards
    (the last padded with dead rows), each on its device; queries are
    replicated.  For corpora that fit one device the forest index is
    faster; this is the path for items that must span several devices'
    memory, and the recall oracle of sharded setups."""

    def __init__(self, mesh: Mesh, vectors: np.ndarray, metric="euclidean", ids=None):
        self.mesh = mesh
        self.metric = resolve_metric(metric)
        m, d = vectors.shape
        self.dims = d
        n = mesh.devices.size
        m_l = -(-m // n)
        m_pad = m_l * n
        rows = self.metric.encode_np(np.asarray(vectors, np.float32))
        rows_p = np.zeros((m_pad, rows.shape[1]), rows.dtype)
        rows_p[:m] = rows
        norms = np.zeros(m_pad, np.float32)
        norms[:m] = self.metric.item_norms_np(rows, d)
        live = np.zeros(m_pad, bool)
        live[:m] = True
        all_ids = np.zeros(m_pad, np.int64)
        all_ids[:m] = np.arange(m) if ids is None else np.asarray(ids, np.uint32)
        self.shards = [
            _ExactShard(self.metric, rows_p[sl], norms[sl], live[sl], all_ids[sl], dev)
            for sl, dev in ((slice(s * m_l, (s + 1) * m_l), mesh.devices[s]) for s in range(n))
        ]

    def search(self, queries: np.ndarray, k: int, candidates=None):
        """Replicated queries against the sharded corpus → numpy (ids [B, k]
        int64, dists [B, k]).  ``candidates``: an item-id allowlist (the
        roaring-∩ filter role, reference: src/reader.rs:354-360) as a
        per-shard live mask, as the single-device exact engine applies it."""
        metric, dims = self.metric, self.dims
        qv, qn = _host_queries(metric, queries, dims)
        allow = None if candidates is None else np.asarray(list(candidates), np.int64)
        parts = []
        for sh in self.shards:
            live = sh.live
            if allow is not None:
                keep = sh.live_np & np.isin(sh.ids_np, allow)
                live = torch.from_numpy(keep).to(sh.device)
            parts.append(sh.topk(metric, dims, int(k), live,
                                 torch.from_numpy(qv).to(sh.device),
                                 torch.from_numpy(qn).to(sh.device)))
        ids, dists = merge_topk(metric, dims, int(k), parts, self.mesh.devices[0])
        return ids.cpu().numpy(), dists.cpu().numpy()


# ---------------------------------------------------------------------------
# sharded build step (the side-assignment sweep, corpus-sharded)
# ---------------------------------------------------------------------------


def sharded_margin_step(mesh: Mesh, metric, n_segments: int, rows, extras, seg_of_item, normals, aux):
    """One forest-build side-assignment sweep over a sharded corpus: items
    (and their segment labels) split contiguously over the mesh, split
    planes replicated.  Returns the margins [m] (on ``devices[0]``) and the
    per-segment left counts [n_segments] summed over shards, so every
    shard sees the global imbalance (builder's count stage, distributed).
    Inputs are host arrays or tensors; ``m`` must divide by the shard
    count, as the JAX package's sharding requires."""
    from .build import _entry_margins

    n = mesh.devices.size
    rows, extras, seg, normals, aux = (
        a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        for a in (rows, extras, seg_of_item, normals, aux)
    )
    m = rows.shape[0]
    if m % n:
        raise ValueError(f"{m} items do not split into {n} equal shards")
    m_l = m // n
    margins, left = [], torch.zeros(n_segments, dtype=torch.int64)
    for s in range(n):
        dev = mesh.devices[s]
        sl = slice(s * m_l, (s + 1) * m_l)
        seg_l = seg[sl].to(dev).long()
        mg = _entry_margins(metric, rows[sl].to(dev), extras[sl].to(dev),
                            torch.arange(m_l, device=dev), seg_l, normals.to(dev), aux.to(dev))
        side = ~torch.signbit(mg)
        left += torch.bincount(seg_l[~side], minlength=n_segments)[:n_segments].cpu()
        margins.append(mg.to(mesh.devices[0]))
    return torch.cat(margins), left.to(torch.int32).to(mesh.devices[0])
