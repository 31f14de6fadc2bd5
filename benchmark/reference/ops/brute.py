"""Dense brute-force intersection for small scenes (frozen copy of the
plain version in clive2_tpu_torch/ops/brute.py: ``pack_brute`` and
``brute_plain``; the kernel dispatch and the pre-test are left out).

Every ray is tested against every triangle of a [T, 10] f32 table (v0, e1,
e2, pad) in ascending triangle order; a triangle replaces the best hit only
when strictly closer, and the best t starts at the ray's ``t_max``.
"""

from __future__ import annotations

import torch

from .intersect import _finish, _init_best, _mt

# scenes at or below this triangle count intersect by dense Moller-Trumbore
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
    best_t, best_i, best_u, best_v = _init_best(origin, t_max)
    o = origin.unbind(-1)
    d = direction.unbind(-1)
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
