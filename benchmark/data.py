"""Inputs of a run, all drawn from ``--seed``: the corpus, the held-out
query pool, the request schedule and the filter set.

The vectors follow the clustered crossover model of the repository's
``bench.py`` (`make_corpus`, the Rust reference's ``sample_vectors``):
each row takes every coordinate from one of two parents among
``parents`` Gaussian parents, plus Gaussian noise.  Here it is drawn on
the run's device by one `torch.Generator`, in a few large calls; the
queries are further rows of the same clusters, drawn after the corpus.
"""

from __future__ import annotations

import numpy as np
import torch

#: rows drawn at a time (bounds the temporaries of one draw)
_SLICE = 1 << 20


def _rows(g, parents, n, noise):
    d = parents.shape[1]
    dev = parents.device
    pa = torch.randint(len(parents), (n,), generator=g, device=dev)
    pb = torch.randint(len(parents), (n,), generator=g, device=dev)
    mask = torch.rand((n, d), generator=g, device=dev) < 0.5
    x = torch.where(mask, parents[pa], parents[pb])
    x += noise * torch.randn((n, d), generator=g, device=dev)
    return x


def vectors(cfg: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(corpus [n_items, dims], query pool [n_queries, dims]), f32 on the
    host, drawn on `device`."""
    model = cfg["corpus_model"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    parents = torch.randn((model["parents"], cfg["dims"]), generator=g, device=device)
    out = []
    for n in (cfg["n_items"], cfg["n_queries"]):
        host = np.empty((n, cfg["dims"]), np.float32)
        for s in range(0, n, _SLICE):
            m = min(_SLICE, n - s)
            host[s:s + m] = _rows(g, parents, m, model["noise"]).cpu().numpy()
        out.append(host)
    return out[0], out[1]


def schedule(n_pool: int, batch: int, seed: int) -> np.ndarray:
    """The request stream: [S, batch] pool indices, S = 2 * ceil(n_pool /
    batch), cut from seeded permutations of the pool laid end to end, so
    every seed sends the same sizes, each query of the pool at least twice,
    in another order.  The closed loop cycles through the S requests."""
    s = 2 * -(-n_pool // batch)
    rng = np.random.default_rng([int(seed), 1])
    reps = -(-s * batch // n_pool)
    stream = np.concatenate([rng.permutation(n_pool) for _ in range(reps)])
    return stream[: s * batch].reshape(s, batch)


def filter_ids(n_items: int, share: float, seed: int) -> np.ndarray:
    """The sorted item ids a filtered request allows: ``share`` of the
    items, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 2])
    n = max(int(round(share * n_items)), 1)
    return np.sort(rng.choice(n_items, n, replace=False)).astype(np.int64)
