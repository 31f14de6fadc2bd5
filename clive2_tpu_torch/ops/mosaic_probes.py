"""The layout probes' kernels: a bf16 slab copied through shared memory, and
two bf16 products with f32 sums.

Replace the TPU kernels of ``scripts/probe_mosaic_layouts.py``:
``dma_probe.kern`` (``pallas_call`` at :47) by ``slab_copy``, ``dotT_kern``
(:77) by ``matmul_t`` and ``dot128_kern`` (:90) by ``matmul``.  The kernels
are csrc/mosaic_probes.cu (bulk asynchronous copies, a band of rows a
block; ``wgmma`` on operands that TMA loads into shared memory, all of K
at once); the ``*_plain`` functions are their plain versions.  A wrapper
takes the plain version for a CPU tensor and launches the kernel for a
CUDA tensor; it raises on anything the kernel does not take.

The plain products multiply by broadcast in f32 and sum over K, not
``torch.matmul``: a product of two bf16 values is exact in f32, so only the
order of the sums differs from the kernel's, and no TF32 flag reaches it.
"""

from __future__ import annotations

import math

import torch

SLAB = 2                      # the script's src.at[2]
WINDOW = (8, 128)             # the script's out[...] = slot[:8, :128]
MAX_SLAB_BYTES = 227 * 1024 - 128    # csrc/mosaic_probes.cu:kMaxSlabBytes
# about what each block of the slab copy moves: chosen on the card against
# 8 KB, 32 KB and one block for the whole slab (PERF.md §6, row 9)
BAND_BYTES = 16 * 1024
# the product kernel's steps (csrc/mosaic_probes.cu: kBM, kBN, kKStep): M
# and N multiples of a block's tile, K of one wgmma's depth, up to MAX_K
# (kMaxK: all of K resident in shared memory)
TILE = dict(m=64, n=32, k=16)
MAX_K = 512
REL = 2.0 ** -14     # a product's tolerance against its plain version,
                     # times abs_product: elementwise


def smem_bytes(k):
    """Dynamic shared memory the product kernel asks for at depth ``k``
    (csrc/mosaic_probes.cu:mma_smem_bytes): A's and B's 64-deep TMA boxes
    and 1 KB to align them to the swizzle's repeat."""
    return 1024 + -(-k // 64) * 64 * 2 * (TILE["m"] + TILE["n"])


def band_rows(rows, cols):
    """Rows of a bf16 slab [rows, cols] that each block of the slab copy
    moves: the most whole rows within ``BAND_BYTES`` whose bytes are a
    multiple of 16 (a bulk copy's unit, so every band starts 16-byte
    aligned), at least the window's rows (block 0 writes the window), at
    most the slab's (one band: the whole slab, a multiple of 16 bytes by
    the slab's contract)."""
    row = 2 * cols
    step = 16 // math.gcd(row, 16)
    want = max(BAND_BYTES // row // step, 1) * step
    window = -(-min(rows, WINDOW[0]) // step) * step
    return min(rows, max(want, window))


def bands(rows, cols):
    """(first row, rows) of each block's band, block 0 first: the grid of
    the slab copy (csrc/mosaic_probes.cu:slab_copy_kernel)."""
    b = band_rows(rows, cols)
    return [(r, min(b, rows - r)) for r in range(0, rows, b)]


def slab_copy_plain(x):
    """``x[SLAB]`` copied into a slot, then the slot's top-left window of
    at most ``WINDOW`` as f32."""
    slab_copy_plain.calls += 1
    slot = x[SLAB].clone()
    return slot[:WINDOW[0], :WINDOW[1]].float()


slab_copy_plain.calls = 0


def _product(a, b):
    """a [M, K] @ b [K, N] in f32: broadcast products summed over K."""
    return (a.float().unsqueeze(2) * b.float().unsqueeze(0)).sum(1)


def matmul_t_plain(a, b):
    """aᵀ b in f32 for a [K, M], b [K, N]: the script's ``dot_general``
    contracting dim 0 of both."""
    matmul_t_plain.calls += 1
    return _product(a.t(), b)


matmul_t_plain.calls = 0


def matmul_plain(a, b):
    """a b in f32 for a [M, K], b [K, N]."""
    matmul_plain.calls += 1
    return _product(a, b)


matmul_plain.calls = 0


def abs_product(a, b, transposed=False):
    """|A|ᵀ|B| (or |A||B|) in f32: times ``REL``, how far two f32 sums of
    the same exact bf16 products may differ, elementwise."""
    return _product((a.t() if transposed else a).abs(), b.abs())


def _check_cuda(what, *ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{what} takes bf16 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: operands on {[str(t.device) for t in ts]}")


def _aligned(t, what, step=16):
    if t.data_ptr() % step:
        raise ValueError(f"{what} must be {step}-byte aligned")
    return t


def slab_copy(x):
    """``slab_copy_plain`` on a CPU tensor; on a CUDA one the kernel: bulk
    asynchronous copies of ``x[SLAB]`` (bf16 [N, R, C]) into shared memory,
    a band of ``band_rows`` rows a block (``bands``), then its window as
    f32."""
    if x.device.type == "cpu":
        return slab_copy_plain(x)
    from .. import kernels

    _check_cuda("slab_copy", x)
    if x.dim() != 3 or x.shape[0] <= SLAB:
        raise ValueError(f"slab_copy takes [N, R, C] with N above {SLAB}, "
                         f"got {tuple(x.shape)}")
    rows, cols = x.shape[1:]
    nbytes = 2 * rows * cols
    if not rows or not cols or nbytes % 16 or nbytes > MAX_SLAB_BYTES:
        raise ValueError(f"a slab of {rows} x {cols} bf16 is {nbytes} bytes:"
                         f" the bulk copy takes a multiple of 16 bytes, at "
                         f"most {MAX_SLAB_BYTES}")
    slab = _aligned(x.contiguous()[SLAB], "the slab")
    out = torch.empty(min(rows, WINDOW[0]), min(cols, WINDOW[1]),
                      device=x.device)
    kernels.call("clive2_slab_copy", x.device, slab.data_ptr(), rows, cols,
                 band_rows(rows, cols), out.data_ptr())
    slab_copy.launches += 1
    return out


slab_copy.launches = 0


def _tma_operand(t, what):
    """``t`` contiguous with the 16-byte aligned base TMA reads from.  Its
    rows are M, N or K bf16 apart, which TILE makes a multiple of 32 bytes,
    so TMA's 16-byte row stride needs no check of its own."""
    return _aligned(t.contiguous(), what)


def _mma(name, a, b, m, k, transposed):
    from .. import kernels

    _check_cuda(name, a, b)
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{name}: b must be [{k}, N], got {tuple(b.shape)}")
    n = b.shape[1]
    if (m % TILE["m"] or n % TILE["n"] or k % TILE["k"] or k > MAX_K
            or not m * n * k):
        raise ValueError(f"{name}: M={m}, N={n}, K={k}; the kernel takes "
                         f"M a multiple of {TILE['m']}, N of {TILE['n']} "
                         f"and K of {TILE['k']} up to {MAX_K}")
    a = _tma_operand(a, f"{name}: a")
    b = _tma_operand(b, f"{name}: b")
    c = torch.empty(m, n, device=a.device)
    kernels.call("clive2_mma_bf16", a.device, a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), m, n, k, int(transposed))
    return c


def matmul_t(a, b):
    """aᵀ b (a bf16 [K, M], b [K, N]) as f32 [M, N]: ``matmul_t_plain`` on
    the CPU, the ``wgmma`` kernel with a K-major A (transposed in shared
    memory) on the card."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_t_plain(a, b)
    if a.dim() != 2:
        raise ValueError(f"matmul_t: a must be [K, M], got {tuple(a.shape)}")
    c = _mma("matmul_t", a, b, a.shape[1], a.shape[0], True)
    matmul_t.launches += 1
    return c


matmul_t.launches = 0


def matmul(a, b):
    """a b (a bf16 [M, K], b [K, N]) as f32 [M, N]: ``matmul_plain`` on the
    CPU, the ``wgmma`` kernel on the card."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    if a.dim() != 2:
        raise ValueError(f"matmul: a must be [M, K], got {tuple(a.shape)}")
    c = _mma("matmul", a, b, a.shape[0], a.shape[1], False)
    matmul.launches += 1
    return c


matmul.launches = 0
