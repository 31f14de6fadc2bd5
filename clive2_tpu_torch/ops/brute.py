"""Dense brute-force intersection for small scenes: the CUDA kernel in
csrc/brute.cu, its plain PyTorch version, and an exact early-reject
pre-test measured on the card and not kept in the kernel (its rule and
exactness argument are in csrc/brute.cu).

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
# the pre-test's margins (csrc/brute.cu's note): a triangle is given up
# when U / a < 0 with |U| > |a| PRETEST_LO, or U / a > 1 with |U| > |a|
# PRETEST_HI (and likewise for V, U + V and T)
PRETEST_LO = 2.0 ** -20
PRETEST_HI = 1.0 + 2.0 ** -20
# where pretest_stage ends a test: at the u, v or t stage, or in the exact
# test (the one brute_plain runs)
STAGES = ("u", "v", "t", "tail")


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


def pretest_stage(origin, direction, tris):
    """The exact early-reject pre-test of csrc/brute.cu's note, in
    brute_plain's expression order: [N, T] int8, the index in ``STAGES`` of
    the stage where it ends the test of ray n against triangle k (3: it
    reaches the exact test).  It never ends a test that brute_plain
    accepts (tests/test_torch_intersect.py).  chip_smoke.py reports on each
    brute cast the share of tests it ends and the share of warps that
    would still run each stage, which decides whether it could pay."""
    o = [c[:, None] for c in origin.unbind(-1)]
    d = [c[:, None] for c in direction.unbind(-1)]
    v0, e1, e2 = (tris[:, j:j + 3].unbind(-1) for j in (0, 3, 6))
    ox, oy, oz = o
    dx, dy, dz = d
    hx = dy * e2[2] - dz * e2[1]
    hy = dz * e2[0] - dx * e2[2]
    hz = dx * e2[1] - dy * e2[0]
    a = e1[0] * hx + e1[1] * hy + e1[2] * hz
    pos = a > 0.0
    lo = a.abs() * PRETEST_LO
    hi = a.abs() * PRETEST_HI
    sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
    uu = sx * hx + sy * hy + sz * hz
    ua = torch.where(pos, uu, -uu)
    end_u = (a == 0.0) | (ua < -lo) | (ua > hi)
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    vv = dx * qx + dy * qy + dz * qz
    va = torch.where(pos, vv, -vv)
    end_v = (va < -lo) | ((ua >= 0.0) & (va >= 0.0) & (ua + va > hi))
    tt = e2[0] * qx + e2[1] * qy + e2[2] * qz
    end_t = torch.where(pos, tt, -tt) < -lo
    stage = torch.full(a.shape, 3, dtype=torch.int8, device=a.device)
    for k, end in ((2, end_t), (1, end_v), (0, end_u)):
        stage = torch.where(end, k, stage)
    return stage


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
