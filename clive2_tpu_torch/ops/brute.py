"""Dense brute-force intersection for small scenes: the CUDA kernel in
csrc/brute.cu and its plain PyTorch version.

Replaces the TPU kernel ``clive2_tpu/ops/brute_pallas.py:_kernel`` (and, on
the CPU, ``intersect_brute_chunked``).  Every ray is tested against every
triangle of a [T, 10] f32 table (v0, e1, e2, pad) in ascending triangle
order; a triangle replaces the best hit only when strictly closer, and the
best t starts at the ray's ``t_max``.
"""

from __future__ import annotations

import torch

from .intersect import WORK, _finish, _init_best, _mt

# scenes at or below this triangle count intersect by dense Möller-Trumbore;
# the kernel stages the table (10 KB at this size) into static shared
# memory of this size (csrc/brute.cu:kMaxTris)
MAX_TRIS = 256


def pack_brute(soup):
    """[T, 10] f32 triangle table: v0(3) e1(3) e2(3) pad(1)."""
    import numpy as np

    tris = np.zeros((len(soup), 10), dtype=np.float32)
    tris[:, 0:3] = soup.vertices[:, 0]
    tris[:, 3:6] = soup.vertices[:, 1] - soup.vertices[:, 0]
    tris[:, 6:9] = soup.vertices[:, 2] - soup.vertices[:, 0]
    return tris


def brute_plain(origin, direction, tris, active=None, t_max=None):
    """Plain PyTorch version of the kernel: one triangle at a time, the
    same arithmetic and the same ascending-k strict-< tie rule."""
    brute_plain.calls += 1
    best_t, best_i, best_u, best_v = _init_best(origin, t_max)
    o = origin.unbind(-1)
    d = direction.unbind(-1)
    WORK["triangles"] += tris.shape[0] * (
        origin.shape[0] if active is None else int(active.sum()))
    for k in range(tris.shape[0]):
        row = tris[k]
        hit, t, u, v = _mt(o, d, row[0:3].unbind(), row[3:6].unbind(),
                           row[6:9].unbind())
        ok = hit & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, k, best_i)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
    return _finish(best_i, best_t, best_u, best_v, active)


brute_plain.calls = 0


def intersect_brute(origin, direction, tris, active=None, t_max=None):
    """Closest hit against every triangle of ``tris`` [T, 10].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch).
    """
    if origin.device.type == "cpu":
        return brute_plain(origin, direction, tris, active, t_max)
    from .. import kernels

    rays = kernels.ray_args(origin, direction, active, t_max)
    if tris.dtype != torch.float32 or tris.dim() != 2 or tris.shape[1] != 10:
        raise ValueError(f"brute table must be f32 [T, 10], got "
                         f"{tuple(tris.shape)} {tris.dtype}")
    if tris.shape[0] > MAX_TRIS:
        raise ValueError(f"brute table holds {tris.shape[0]} triangles; "
                         f"the kernel takes at most {MAX_TRIS}")
    tris = kernels.on_device(tris.contiguous(), origin.device, "tris")
    out = kernels.hit_outputs(origin)
    if rays.n:
        kernels.call("clive2_brute", origin.device, *rays.pointers(),
                     kernels.ptr(tris), tris.shape[0],
                     *map(kernels.ptr, out))
        intersect_brute.launches += 1
    return out


intersect_brute.launches = 0
