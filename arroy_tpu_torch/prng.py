"""Counter-based threefry2x32 draws, bit for bit those of `jax.random`.

The JAX package draws every random choice of a build from threefry keys
(two 32-bit words), so a seed fixes the forest on every backend.  This
module computes the same words with plain PyTorch integer ops, on any
device, so the port grows the same forest from the same seed.  It holds
the semantics of JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the default since JAX 0.5): bit *i* of
``random_bits(key, 32, shape)`` is ``threefry2x32(key, (i >> 32, i))``
whatever the shape, so a draw can be made at any set of counters alone.

A key on the host is a numpy uint32 ``[2]`` (``key``, ``fold_in`` and
``split`` derive host keys with Python integers); on a device it is an
int64 tensor ``[..., 2]`` of 32-bit words, each kept in ``[0, 2**32)`` by
``& 0xFFFFFFFF`` after each add, multiply and shift (torch's uint32
arithmetic is partial).  Batched keys broadcast: a function given keys
``[S, 2]`` draws for each of the S keys at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import fma32

_M = 0xFFFFFFFF
#: threefry2x32's key-schedule parity word and its two rotation quads
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block (20 rounds): key words ``(k0, k1)`` and
    counter words ``(x0, x1)``: int64 tensors of 32-bit words that
    broadcast together, or Python ints.  Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    # x1 is reduced mod 2**32 after every step that feeds a rotation; x0
    # only feeds adds and the low word of a xor, so it carries its high
    # bits (under 2**40 after 25 adds) and is reduced once at the end
    x0 = x0 + k0
    x1 = (x1 + k1) & _M
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M
        x0 = x0 + ks[(block + 1) % 3]
        x1 = (x1 + (ks[(block + 2) % 3] + (block + 1))) & _M
    return x0 & _M, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s words on the host: ``[0, seed mod 2**32]``
    (with x64 off, JAX reads a Python int seed as 32 bits)."""
    return np.array([0, int(seed) & _M], np.uint32)


def key_data(k) -> np.ndarray:
    """The key's words as uint32, as ``jax.random.key_data`` gives them."""
    if isinstance(k, torch.Tensor):
        k = k.cpu().numpy()
    return np.asarray(k).astype(np.uint32)


def as_tensor(k, device) -> torch.Tensor:
    """A host key (or keys ``[..., 2]``) as int64 words on ``device``."""
    if isinstance(k, torch.Tensor):
        return k.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(k, np.int64), device=device)


def _hash(k, hi, lo):
    """``threefry2x32(k, (hi, lo))`` as keys ``[..., 2]``; a host key with
    integer counters gives a host key."""
    if isinstance(k, np.ndarray):
        y0, y1 = threefry2x32(int(k[0]), int(k[1]), int(hi), int(lo))
        return np.array([y0, y1], np.uint32)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], hi, lo)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in``: the block at counter ``(0, data)``.  ``data``
    is an int, or for device keys an int tensor broadcast against the
    keys' batch shape (JAX folds one scalar at a time; a tensor is that
    under vmap).  An int enters the block as it is: no tensor is made
    for it, so no copy to the device."""
    if isinstance(data, torch.Tensor):
        return _hash(k, 0, data.to(device=k.device, dtype=torch.int64) & _M)
    return _hash(k, 0, int(data) & _M)


def split(k, num: int = 2):
    """``jax.random.split`` (the fold-like, partitionable form): key *i*
    is the block at counter ``(0, i)``.  Returns ``[..., num, 2]``."""
    if isinstance(k, np.ndarray):
        return np.stack([_hash(k, 0, i) for i in range(num)])
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return _hash(k[..., None, :], 0, i)


def bits_at(k: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """32-bit ``random_bits`` at flat positions ``counters`` (int64,
    broadcast against the keys' batch shape): ``y0 ^ y1`` of the block at
    ``(i >> 32, i)``."""
    c = counters.to(device=k.device, dtype=torch.int64)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], (c >> 32) & _M, c & _M)
    return y0 ^ y1


def random_bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)``: ``[*batch, *shape]`` words."""
    shape = tuple(shape)
    kb = k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,))
    return bits_at(kb, _counters(shape, k.device))


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` in int32 (x64 off):
    the two keys of ``split(k)`` draw the high and low words
    (`randint_words`).  ``minval``/``maxval`` lie in int32 and broadcast
    against the keys' batch shape.  Returns int64 values ``[*batch,
    *shape]``."""
    shape = tuple(shape)
    words = random_bits(split(k), shape)  # [*batch, 2, *shape]
    hi, lo = words.unbind(k.dim() - 1)
    lead = (1,) * len(shape)
    mn, mx = (v.reshape(v.shape + lead) if isinstance(v, torch.Tensor) else v
              for v in (minval, maxval))
    return randint_words(hi, lo, mn, mx)


def randint_words(hi: torch.Tensor, lo: torch.Tensor, minval, maxval) -> torch.Tensor:
    """randint's value from its high and low words: the offset is
    ``((hi % span) * m + lo % span) % span`` in uint32, with
    ``m = (2**16 % span)**2 % span`` (0 once span passes 2**16, since
    2**32 wraps to 0), and ``span = 1`` where ``maxval <= minval``;
    ``minval + offset`` wraps in int32.  The bounds are ints or int
    tensors that broadcast against the words."""
    mn, mx = _int32(minval, hi.device), _int32(maxval, hi.device)
    if isinstance(mn, int) and isinstance(mx, int):
        span = (mx - mn) & _M if mx > mn else 1
    else:
        span = torch.where(mx <= mn, 1, (mx - mn) & _M)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    off = ((((hi % span) * mult) & _M) + lo % span) & _M
    off = off % span
    out = (mn + off) & _M
    return torch.where(out >= 1 << 31, out - (1 << 32), out)


def _int32(v, device):
    """A bound read as int32: a Python int, or an int64 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=torch.int64) & _M
        return torch.where(v >= 1 << 31, v - (1 << 32), v)
    v = int(v) & _M
    return v - (1 << 32) if v >= 1 << 31 else v


def uniform(k: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2) (``bits >> 9 | 0x3F800000``), minus 1.0, scaled
    by ``maxval - minval`` and shifted by ``minval`` in one fused
    multiply-add (XLA contracts it), then floored at ``minval``."""
    return _floats(random_bits(k, shape), minval, maxval)


def _floats(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    return torch.clamp(fma32(f, np.float32(maxval) - lo, lo), min=float(lo))


def bernoulli(k: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low'): ``uniform < p`` in float32."""
    return uniform(k, shape) < float(np.float32(p))


def _counters(shape, device) -> torch.Tensor:
    """The flat positions of a draw of ``shape``, in that shape."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def bernoulli_at(k: torch.Tensor, counters: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """``bernoulli(k, p, shape)`` read at flat positions ``counters`` only
    (keys and counters broadcast): the draws of those lanes of a larger
    shape, which the partitionable stream makes independent of it."""
    return _floats(bits_at(k, counters), 0.0, 1.0) < float(np.float32(p))
