"""Kernel 6's CPU side (`ops.rank_select`): the plain chain, the route
rule, the work record and the wrapper's checks.

The kernel cannot run here; `tests/test_torch_cuda.py` holds it (and its
column-range plan) to `rank_blocks_reference` on the card.
"""

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch import probe as t_probe
from arroy_tpu_torch.metrics import metric_by_name
from arroy_tpu_torch.ops import rank_select as rs
from arroy_tpu_torch.ops.binary import unpack_bits
from arroy_tpu_torch.utils import profiling

def _old_rank_blocks(metric, L, nb_max, scale, cent, caux, valid, qv):
    """`probe._rank_blocks` as it was before kernel 6, frozen."""
    b = qv.shape[0]
    T = cent.shape[0] // nb_max
    qcent = unpack_bits(qv, cent.shape[1]) if metric.binary else qv
    flags = torch.backends.cuda.matmul
    tf32, flags.allow_tf32 = flags.allow_tf32, False
    try:
        dots = qcent @ cent.T
    finally:
        flags.allow_tf32 = tf32
    score = float(scale) * dots - caux[None, :]
    score = torch.where(valid[None, :], score, -float("inf"))
    topL = torch.topk(score.reshape(b, T, nb_max), L, dim=2).indices
    base = (torch.arange(T, device=qv.device) * nb_max)[None, :, None]
    return (topL + base).reshape(b, T * L)


def _tables(rng, T, nb_max, d, scale, valid_share=0.9):
    cent = rng.standard_normal((T * nb_max, d)).astype(np.float32)
    caux = np.einsum("nd,nd->n", cent, cent).astype(np.float32) if scale == 2 else \
        np.zeros(T * nb_max, np.float32)
    valid = rng.random(T * nb_max) < valid_share
    valid[::nb_max] = True
    return torch.from_numpy(cent), torch.from_numpy(caux), torch.from_numpy(valid)


@pytest.mark.parametrize("metric_name", ["cosine", "euclidean", "dot-product",
                                         "binary quantized cosine"])
@pytest.mark.parametrize("b,T,nb_max,d,L", [(1, 2, 40, 16, 1), (7, 3, 300, 100, 25),
                                            (33, 8, 130, 37, 130)])
def test_reference_is_the_old_chain_bit_for_bit(metric_name, b, T, nb_max, d, L):
    """`rank_blocks_reference`, `rank_blocks` on the CPU and `probe._rank_blocks`
    return what stage 1 returned before kernel 6, bit for bit."""
    metric = metric_by_name(metric_name)
    rng = np.random.default_rng(b * 31 + d)
    scale = t_probe.block_scale(metric)
    L = min(L, nb_max)
    if metric.binary:
        d = 32 * (-(-d // 32))
        cent, caux, valid = _tables(rng, T, nb_max, d, scale)
        qv = torch.from_numpy(rng.integers(-2**31, 2**31, (b, d // 32), dtype=np.int64)
                              .astype(np.int32))
        qcent = unpack_bits(qv, d)
    else:
        cent, caux, valid = _tables(rng, T, nb_max, d, scale)
        qv = qcent = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    want = _old_rank_blocks(metric, L, nb_max, scale, cent, caux, valid, qv)
    assert want.dtype == torch.int64 and want.shape == (b, T * L)
    assert torch.equal(rs.rank_blocks_reference(qcent, cent, caux, valid, scale, L, nb_max), want)
    n0, p0 = dict(rs.launches), dict(rs.plain_calls)
    assert torch.equal(rs.rank_blocks(qcent, cent, caux, valid, scale, L, nb_max), want)
    assert torch.equal(t_probe._rank_blocks(metric, L, nb_max, scale, cent, caux, valid, qv), want)
    assert rs.launches == n0 and rs.plain_calls == p0  # the CPU neither launches nor counts


def test_route_limit_on_L():
    """The route's limit on L is at least 64 and within the kernel's 128."""
    assert 64 <= rs.MAX_L <= 128 and rs.CROSSOVER_L[-1] == rs.MAX_L


@pytest.mark.parametrize("entry", sorted(rs.CROSSOVER))
@pytest.mark.parametrize("col", range(len(rs.CROSSOVER_L)))
def test_route_rule_at_each_crossover(entry, col):
    """At each measured crossover, on a table of exactly its blocks and its
    width and L: the kernel from its fewest queries on, the plain chain
    under it; on every other device the plain chain."""
    blocks, d = entry
    L = rs.CROSSOVER_L[col]
    least = rs.CROSSOVER[entry][col]
    assert rs.min_queries(blocks, d, L) == least
    for b in (least, least + 1, 2048, 1 << 20):
        assert rs.uses_kernel(b, L, d, blocks, "cuda")
        assert rs.uses_kernel(b, L, d, blocks, torch.device("cuda", 1))
        assert not rs.uses_kernel(b, L, d, blocks, "cpu")
    assert not rs.uses_kernel(least - 1, L, d, blocks, "cuda")


@pytest.mark.parametrize("blocks,d,L,least", [
    (8 * 29_568, 100, 25, 64),     # the probe cell's tables
    (8 * 4_360, 768, 9, 128),      # a 262,144 x 768 probe's
    (8 * 4_360, 768, 25, 256),
    (8 * 2_180, 768, 25, 512),     # f32 tables: half the trees
    (8 * 4_360, 512, 1, 128),      # between widths: the wider entry's
    (8 * 4_360, 100, 10, 64),      # between L: the larger L's
    (8_800, 32, 64, 512),
    (8_799, 100, 1, None),         # fewer blocks than any entry
    (10 ** 6, 769, 1, None),       # wider than any entry
    (10 ** 6, 100, 65, None),      # past MAX_L
    (10 ** 6, 100, 128, None),
])
def test_route_rule_between_entries(blocks, d, L, least):
    """A shape between entries takes the next stricter one; past the
    largest width or L, or under the fewest blocks, the plain chain."""
    assert rs.min_queries(blocks, d, L) == least
    if least is None:
        assert not rs.uses_kernel(1 << 20, L, d, blocks, "cuda")


def test_route_rule_is_monotone():
    """More blocks, a narrower d or a smaller L never need more queries."""
    for (n, w), row in rs.CROSSOVER.items():
        assert list(row) == sorted(row)
        for (n2, w2), row2 in rs.CROSSOVER.items():
            if n2 >= n and w2 <= w:
                assert all(a2 <= a for a, a2 in zip(row, row2)), ((n, w), (n2, w2))


def test_other_devices_raise():
    """Neither the CPU nor a CUDA device: `rank_blocks` raises."""
    rng = np.random.default_rng(2)
    cent, caux, valid = _tables(rng, 2, 300, 8, 1)
    q = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    meta = [t.to("meta") for t in (q, cent, caux, valid)]
    with pytest.raises(ValueError, match="device"):
        rs.rank_blocks(*meta[:3], meta[3], 1, 25, 300)


def test_work_record_fields():
    """One record a call under `profiling.counting()`: B, T, nb_max, L, d
    and the route (the plain chain on the CPU); none outside it."""
    rng = np.random.default_rng(0)
    cent, caux, valid = _tables(rng, 4, 50, 12, 2)
    q = torch.from_numpy(rng.standard_normal((9, 12)).astype(np.float32))
    with profiling.counting() as works:
        out = rs.rank_blocks(q, cent, caux, valid, 2, 7, 50)
    assert works == [{"kernel": "rank_select", "B": 9, "T": 4, "nb_max": 50, "L": 7, "d": 12,
                      "route": "plain"}]
    assert torch.equal(out, rs.rank_blocks(q, cent, caux, valid, 2, 7, 50))
    assert rs.work(q, cent, 7, 50, "kernel")["route"] == "kernel"


def _bad_inputs():
    rng = np.random.default_rng(1)
    cent, caux, valid = _tables(rng, 3, 20, 8, 1)
    q = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    ok = dict(qcent=q, cent=cent, caux=caux, valid=valid, scale=1, L=4, nb_max=20)
    meta = torch.empty((5, 8), dtype=torch.float32, device="meta")
    return [
        (TypeError, dict(ok, cent=cent.double())),
        (TypeError, dict(ok, qcent=q.half())),
        (TypeError, dict(ok, valid=valid.to(torch.uint8))),
        (TypeError, dict(ok, caux=caux.long())),
        (ValueError, dict(ok, qcent=q[:, :6].contiguous())),
        (ValueError, dict(ok, caux=caux[:-1])),
        (ValueError, dict(ok, valid=valid[:-1])),
        (ValueError, dict(ok, cent=cent[:-1])),            # N not a multiple of nb_max
        (ValueError, dict(ok, qcent=q.reshape(-1))),
        (ValueError, dict(ok, L=0)),
        (ValueError, dict(ok, L=21)),                      # past the blocks of a tree
        (ValueError, dict(ok, nb_max=0)),
        (ValueError, dict(ok, qcent=meta)),                # another device
        (ValueError, dict(ok, qcent=torch.from_numpy(
            rng.standard_normal((8, 5)).astype(np.float32)).T)),  # not contiguous
        (ValueError, dict(ok, cent=torch.from_numpy(
            rng.standard_normal((8, 60)).astype(np.float32)).T)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_wrapper_rejects_bad_inputs(case):
    err, kw = _bad_inputs()[case]
    with pytest.raises(err):
        rs.rank_blocks(**kw)


def test_probe_records_stage1_work():
    """A probe searcher's request records stage 1 once a batch, with the
    tables' geometry."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    db = Database(None, device="cpu")
    w = Writer(db, 0, 24, metric="euclidean")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=3).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="euclidean")
    s = r.searcher(10, search_k=600, engine="forest", traversal="probe", probe_trees=3,
                   probe_block=16)
    dq = s.prepare_queries(x[:20])
    with profiling.counting() as works:
        s.device_fn(*dq)
    ranks = [w for w in works if w["kernel"] == "rank_select"]
    t = s.device_fn.tables
    assert ranks == [{"kernel": "rank_select", "B": 20, "T": 3, "nb_max": t.nb_max,
                      "L": s.device_fn.L, "d": 24, "route": "plain"}]
