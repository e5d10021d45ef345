"""Kernel 3's epilogue and the probe's one-pass stage 2, on the CPU.

The plain version of the epilogue (`ops.gather_score.apply_epilogue`,
which `gather_score` runs for CPU tensors) against a frozen copy of the
probe's stage-2 chain from before the epilogue moved into the kernel:
every score and every winner's slot bit-equal, for each metric's op, row
type and filter.  Then the chunk rule: the card's counts the kernel's own
temporaries (the probe cell's selection in one chunk), the CPU's is the
JAX package's.  The kernel itself is held to the plain chain bit for bit
on the card (`tests/test_torch_cuda.py -k epilogue`).
"""

import numpy as np
import pytest
import torch

from arroy_tpu_torch import Database, Reader, Writer
from arroy_tpu_torch import probe
from arroy_tpu_torch.ops import gather_score as gs

from .torch_util import dots_epilogue

_INF = float("inf")


def _old_stage2(name, blk_rows, blk_aux, blk_slots, blk_scale, fmask, bidc, qk):
    """The probe's `score_blocks` for bf16 / f32 / int8 rows before the
    epilogue moved into kernel 3 (frozen): raw dots of the clamped ids,
    then the scale, the metric's op and the masks as PyTorch ops, and the
    [B, c, P] slots beside the scores."""
    safe = torch.clamp(bidc, min=0)
    baux = blk_aux[safe]
    bslot = torch.where((bidc >= 0)[..., None], blk_slots[safe], -1)
    d2 = gs.gather_score(blk_rows, safe.to(torch.int32).contiguous(), qk, dots_epilogue(blk_rows))
    if blk_rows.dtype == torch.int8:
        d2 = d2 * blk_scale[safe]
    if name in ("euclidean", "manhattan"):
        s2 = 2.0 * d2 - baux
    elif name == "cosine":
        s2 = d2 / torch.clamp(baux, min=1e-30)
    else:
        s2 = d2
    keep = bslot >= 0
    if fmask is not None:
        keep = keep & fmask[torch.clamp(bslot, min=0)]
    return torch.where(keep, s2, -_INF), torch.where(keep, bslot, -1)


def _tables(dtype, nbt=40, p=16, d=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    xf = torch.randn((nbt, p, d), generator=g)
    rows = {"f32": xf, "bf16": xf.to(torch.bfloat16),
            "int8": torch.clamp(torch.round(xf * 40), -127, 127).to(torch.int8)}[dtype]
    cap = nbt * p + 3
    slots = torch.randperm(cap, generator=g)[: nbt * p].view(nbt, p).to(torch.int32)
    slots[torch.rand((nbt, p), generator=g) < 0.2] = -1
    slots[5] = -1  # a block with no live slot
    aux = torch.rand((nbt, p), generator=g) * 3
    aux[torch.rand((nbt, p), generator=g) < 0.1] = 0.0  # cosine's floor
    scale = torch.rand((nbt, p), generator=g) / 50 if dtype == "int8" else torch.zeros(1, 1)
    fmask = torch.rand(cap, generator=g) < 0.5
    return rows, aux, slots, scale, fmask


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "cosine", "dot-product", "custom"])
@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("filtered", [False, True])
def test_epilogue_equals_the_old_stage2(metric, dtype, filtered):
    """`gather_score` with the probe's epilogue writes the old chain's
    scores bit for bit (-1 ids, -1 slots, filtered slots -inf), and the
    winners' slots read from the table (`probe.winner_slots`) are the old
    chain's slots at the same winners, at a cut and uncut."""
    rows, aux, slots, scale, fmask = _tables(dtype, seed=len(metric) + len(dtype))
    fmask = fmask if filtered else None
    g = torch.Generator().manual_seed(3)
    b, c = 9, 7
    bid = torch.randint(0, rows.shape[0], (b, c), generator=g)
    bid[0, 4:] = -1
    bid[3, 1] = 5
    q = torch.randn((b, rows.shape[2]), generator=g)
    qk = q if dtype == "f32" else q.to(torch.bfloat16).float()
    want_s, want_slot = _old_stage2(metric, rows, aux, slots, scale, fmask, bid, qk)
    ep = gs.Epilogue(probe.score_op(metric), aux, slots, scale if dtype == "int8" else None, fmask)
    got = gs.gather_score(rows, bid.to(torch.int32), qk, ep)
    assert torch.equal(got, want_s)
    assert bool(torch.isinf(got[0, 4:]).all()) and bool(torch.isinf(got[3, 1]).all())
    flat_s, flat_slot = want_s.reshape(b, -1), want_slot.reshape(b, -1)
    for width in (12, c * rows.shape[1]):
        v, i = torch.topk(got.reshape(b, -1), width, dim=1)
        assert torch.equal(probe.winner_slots(v, i, bid, slots), torch.gather(flat_slot, 1, i))
        assert torch.equal(v, torch.gather(flat_s, 1, i))


def test_epilogue_ops_by_metric():
    assert [probe.score_op(m) for m in ("euclidean", "manhattan", "cosine", "dot-product",
                                         "custom")] == ["euclidean", "euclidean", "cosine",
                                                        "dot", "dot"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_gather_chunk_takes_the_probe_cell_in_one_card_chunk(dtype):
    """The probe cell's selection (B 2048, T·L = 8 × 25, P 64, d 100 over 8
    × 29,568 blocks): one chunk under the card's rule, whose temporaries
    are the [B, C, P] f32 scores (105 MB) and the schedule's scratch; 16
    chunks of 13 under the JAX package's rule for bf16 rows."""
    rows = torch.empty((8 * 29_568, 64, 100), dtype=dtype, device="meta")
    assert not probe.stage2_kernel(rows)
    ch = probe.gather_chunk(2048, rows, True)
    assert ch >= 200
    free = probe.PROBE_GATHER_BYTES - 4 * gs.schedule_words(0, rows.shape[0])
    assert 2048 * ch * (4 * 64 + 8) <= free < 2048 * (ch + 1) * (4 * 64 + 8)
    if dtype == torch.bfloat16:
        ch_jax = probe.gather_chunk(2048, rows, False)
        assert (ch_jax, -(-200 // ch_jax)) == (13, 16)
    # past the budget the card's rule still cuts: 2,000 blocks a query
    assert -(-2000 // ch) == 2


def test_gather_chunk_keeps_the_jax_rule_off_the_card():
    """The CPU's and the sign-bit rows' chunks are the JAX package's,
    `PROBE_GATHER_BYTES` over a [b, 1, P, d] slab of gathered rows and
    temporaries (6 bytes a bf16 element, 8 f32 and packed words, 4 int8)."""
    budget = probe.PROBE_GATHER_BYTES
    for dtype, per in ((torch.bfloat16, 6), (torch.float32, 8), (torch.int8, 4), (torch.int32, 8)):
        rows = torch.zeros((3, 16, 24), dtype=dtype)
        assert not probe.stage2_kernel(rows)
        assert probe.gather_chunk(64, rows, False) == budget // (64 * 16 * 24 * per)
    assert gs.schedule_words(409_600, 236_544) == 2 * 409_600 + 236_545 + 58


def test_chunked_calls_count_the_card_only(monkeypatch):
    """A CPU probe cut into chunks (`PROBE_GATHER_BYTES` = 1: a block a
    chunk) answers as in one pass and leaves `chunked_calls`, the card's
    counter, as it was."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    db = Database(None, device="cpu")
    w = Writer(db, 0, 16, metric="cosine")
    with db.write() as wtxn:
        w.add_items(wtxn, np.arange(len(x)), x)
        w.builder(seed=5).n_trees(4).build(wtxn)
    r = Reader.open(db.read(), 0, db, metric="cosine")
    s = r.searcher(10, search_k=300, engine="forest", traversal="probe", probe_trees=4,
                   probe_block=16)
    q = x[:20] + 0.01
    want = s(q)
    c0 = probe.chunked_calls
    monkeypatch.setattr(probe, "PROBE_GATHER_BYTES", 1)
    assert s(q) == want
    assert probe.chunked_calls == c0
