"""Counter-based threefry2x32 keys, bit for bit with ``jax.random``.

The JAX package draws every random number from ``jax.random`` keys
(``key(seed)``, ``fold_in``, ``split``, ``uniform``) under
``jax_threefry_partitionable=True``.  This module reproduces those four
operations exactly, so the port can be fed the reference's keys and held to
it at float tolerance rather than only in distribution.

A key is an int64 tensor of shape [2] holding two uint32 words.  PyTorch's
uint32 arithmetic is partial, so every word lives in an int64 lane and is
masked back to 32 bits after each add or shift.  There is no global
generator: every sampling function takes its key explicitly, and a key's
device decides where its random numbers are made.
"""

from __future__ import annotations

import torch

from .utils.profiling import spanned

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


@spanned("rng")
def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under key (k0, k1).

    All inputs are int64 tensors (or Python ints) holding uint32 values;
    they broadcast.  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def key(seed: int, device="cpu"):
    """``jax.random.key(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def wrap_key_data(data, device="cpu"):
    """A key from its two uint32 words (``jax.random.key_data`` layout)."""
    words = [int(w) & _M for w in data]
    return torch.tensor(words, dtype=torch.int64, device=device)


def key_data(k):
    """The key's two words as a host list of Python ints."""
    return [int(w) for w in k.tolist()]


def fold_in(k, data):
    """``jax.random.fold_in``: hash the counter (0, data) under ``k``."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64)
    x0 = torch.zeros((), dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[0], k[1], x0, data & _M)
    return torch.stack([x0, x1])


def split(k, num: int = 2):
    """``jax.random.split`` (partitionable): key i hashes counter (0, i)."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=1)


def random_bits(k, shape, rows=None):
    """32 random bits per element (partitionable): element i of the
    row-major flattened shape hashes the 64-bit counter i.

    ``rows`` ([M] integer tensor) draws only those rows of the leading
    dimension, shape ``(M, *shape[1:])``: bit for bit the same rows of the
    full draw, whose size then does not matter.  A tile of a wavefront
    draws its own lanes of the frame's random numbers this way."""
    inner = 1
    for s in shape[1:]:
        inner *= int(s)
    if rows is None:
        n = 1
        for s in shape:
            n *= int(s)
        idx = torch.arange(n, dtype=torch.int64, device=k.device)
        out_shape = tuple(shape)
    else:
        rows = rows.to(device=k.device, dtype=torch.int64)
        idx = (rows[:, None] * inner + torch.arange(
            inner, dtype=torch.int64, device=k.device)).reshape(-1)
        out_shape = (rows.shape[0],) + tuple(shape[1:])
    b0, b1 = threefry2x32(k[0], k[1], idx >> 32, idx & _M)
    return (b0 ^ b1).reshape(out_shape)


def uniform(k, shape, rows=None):
    """``jax.random.uniform(k, shape)`` in [0, 1) as float32 (only the
    leading-dimension ``rows`` of it when given, as ``random_bits``): the
    top 23 bits become the mantissa of a float in [1, 2), minus one."""
    bits = (random_bits(k, shape, rows) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
