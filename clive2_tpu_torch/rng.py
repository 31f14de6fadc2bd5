"""Counter-based threefry2x32 keys, bit for bit with ``jax.random``.

The JAX package draws every random number from ``jax.random`` keys
(``key(seed)``, ``fold_in``, ``split``, ``uniform``) under
``jax_threefry_partitionable=True``.  This module reproduces those four
operations exactly, so the port can be fed the reference's keys and held to
it at float tolerance rather than only in distribution.

A key is an int64 tensor of shape [2] holding two uint32 words.  There is
no global generator: every sampling function takes its key explicitly, and
a key's device decides where its random numbers are made.  On the card a
draw, a ``fold_in`` and a ``split`` are one launch each of ``csrc/rng.cu``
(``uniform_kernel``, ``keys_kernel``), which reads the key on the device;
on the CPU their plain versions run (``random_bits_plain``,
``fold_in_plain``, ``split_plain``): the hash as PyTorch ops, each word in
an int64 lane masked back to 32 bits after each add or shift, since
PyTorch's uint32 arithmetic is partial.  Both give the same bits.
"""

from __future__ import annotations

import torch

from . import kernels
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
    """``jax.random.fold_in``: hash the counter (0, data) under ``k``.

    Off the CPU ``data`` is a Python integer: the kernel takes the counter
    as an argument, and reading a tensor's value would stall the host."""
    if k.device.type == "cpu":
        return fold_in_plain(k, data)
    if isinstance(data, torch.Tensor):
        raise TypeError(f"fold_in on a key on {k.device} takes an integer, "
                        "not a tensor")
    return keys_kernel(k, int(data) & _M, 1).reshape(2)


def split(k, num: int = 2):
    """``jax.random.split`` (partitionable): key i hashes counter (0, i)."""
    if k.device.type == "cpu":
        return split_plain(k, num)
    return keys_kernel(k, 0, num)


def random_bits(k, shape, rows=None):
    """32 random bits per element (partitionable): element i of the
    row-major flattened shape hashes the 64-bit counter i.

    ``rows`` ([M] integer tensor) draws only those rows of the leading
    dimension, shape ``(M, *shape[1:])``: bit for bit the same rows of the
    full draw, whose size then does not matter.  A tile of a wavefront
    draws its own lanes of the frame's random numbers this way."""
    if k.device.type == "cpu":
        return random_bits_plain(k, shape, rows)
    return uniform_kernel(k, shape, _rows_on(k, rows), bits=True)


def uniform(k, shape, rows=None):
    """``jax.random.uniform(k, shape)`` in [0, 1) as float32 (only the
    leading-dimension ``rows`` of it when given, as ``random_bits``): the
    top 23 bits become the mantissa of a float in [1, 2), minus one."""
    if k.device.type == "cpu":
        return uniform_plain(k, shape, rows)
    return uniform_kernel(k, shape, _rows_on(k, rows))


def _rows_on(k, rows):
    """``rows`` as the draws take them: int64 on the key's device, in
    order (what the plain version makes of them)."""
    if rows is None:
        return None
    return rows.to(device=k.device, dtype=torch.int64).contiguous()


# ---- the plain versions ------------------------------------------------------

def fold_in_plain(k, data):
    """``fold_in`` as tensor ops, on any device."""
    fold_in_plain.calls += 1
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64)
    x0 = torch.zeros((), dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[0], k[1], x0, data & _M)
    return torch.stack([x0, x1])


fold_in_plain.calls = 0


def split_plain(k, num: int = 2):
    """``split`` as tensor ops, on any device."""
    split_plain.calls += 1
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=1)


split_plain.calls = 0


def random_bits_plain(k, shape, rows=None):
    """``random_bits`` as tensor ops, on any device."""
    random_bits_plain.calls += 1
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


random_bits_plain.calls = 0


def uniform_plain(k, shape, rows=None):
    """``uniform`` as tensor ops, on any device."""
    bits = (random_bits_plain(k, shape, rows) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ---- the kernels' wrappers (csrc/rng.cu) -------------------------------------

def _checked_key(k):
    if (not isinstance(k, torch.Tensor) or k.dtype != torch.int64
            or tuple(k.shape) != (2,) or not k.is_contiguous()):
        raise ValueError("a key must be a contiguous int64 [2] tensor, got "
                         f"{getattr(k, 'shape', k)} "
                         f"{getattr(k, 'dtype', type(k))}")
    return k


@spanned("rng")
def uniform_kernel(k, shape, rows=None, bits: bool = False):
    """``uniform`` (float32), or ``random_bits`` (int64) when ``bits``,
    through ``clive2_rng_uniform``, on the key's device: one launch, no
    host read of a device value.  ``rows``: None or a contiguous int64
    [M] tensor on the key's device."""
    _checked_key(k)
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"a draw of shape {shape}")
    inner = 1
    for s in shape[1:]:
        inner *= s
    if rows is None:
        n_rows = shape[0] if shape else 1
        out_shape = shape
    else:
        if (rows.dtype != torch.int64 or rows.dim() != 1
                or not rows.is_contiguous() or rows.device != k.device):
            raise ValueError(f"rows must be a contiguous int64 [M] tensor on "
                             f"{k.device}, got {tuple(rows.shape)} "
                             f"{rows.dtype} on {rows.device}")
        n_rows = rows.shape[0]
        out_shape = (n_rows,) + shape[1:]
    out = torch.empty(out_shape, device=k.device,
                      dtype=torch.int64 if bits else torch.float32)
    if out.numel():
        kernels.call("clive2_rng_uniform", k.device, k.data_ptr(),
                     None if rows is None else rows.data_ptr(), n_rows,
                     inner, int(bits), out.data_ptr())
        uniform_kernel.launches += 1
    return out


uniform_kernel.launches = 0


@spanned("rng")
def keys_kernel(k, first: int, count: int):
    """``count`` keys [count, 2] hashed from counters (0, first + i) under
    ``k``, through ``clive2_rng_keys``, on the key's device: ``fold_in`` is
    (data, 1), ``split`` (0, num).  One launch, no host read."""
    _checked_key(k)
    first, count = int(first), int(count)
    if not 0 <= count < 2**31 or not 0 <= first <= _M:
        raise ValueError(f"keys {first} + [0, {count}): the kernel takes a "
                         "32-bit counter and fewer than 2^31 keys")
    out = torch.empty((count, 2), dtype=torch.int64, device=k.device)
    if count:
        kernels.call("clive2_rng_keys", k.device, k.data_ptr(), first, count,
                     out.data_ptr())
        keys_kernel.launches += 1
    return out


keys_kernel.launches = 0
