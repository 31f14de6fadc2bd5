"""Ray-scene intersection of the reference (frozen copy of the plain parts
of clive2_tpu_torch/ops/intersect.py: the Moller-Trumbore arithmetic in its
fixed order, the sensor-plane merge and the stable ray order), with a
dispatch of its own in place of the program's kernels.

Contract, as the program's ``intersect_scene``: rays ``origin``/
``direction`` [N, 3] f32, an optional ``active`` [N] bool mask (inactive
rays miss) and an optional per-ray ``t_max`` [N] cap (hits at or beyond it
are ignored).  Returns (tri_id [N] i32, t, u, v): misses report tri_id -1
and t = inf, and hits closer than DELTA are rejected as self-hits.  A scene
with a ``brute`` table is tested densely; any other is the closest hit of
its ``dense`` triangles (the room and its light) and of its ``lbvh`` (the
mesh files' triangles, ``lbvh.py``), merged with the sensor plane.
"""

from __future__ import annotations

import torch

from ..constants import DELTA

INF = float("inf")

# A box or a stack entry is culled past cull_bound(best t), not past the
# best t itself: a box that holds a hit at exactly the best t can round its
# slab entry an ulp past that hit's Möller-Trumbore t, and culled at the best
# t it would be tested or not depending on the visit order, so the (t, slot)
# tie rule (or an ulp-closer hit) would too (csrc/common.cuh:cull_bound).
CULL_SLACK = 1.0 + 2.0 ** -16


def cull_bound(bt):
    """The culling bound of best t ``bt``, as the kernels round it."""
    return bt * CULL_SLACK


def safe_inverse(d):
    """1/direction with zero components nudged to keep the slab test
    NaN-free."""
    tiny = 1e-30
    nudged = torch.where(d < 0, -tiny, tiny)
    return 1.0 / torch.where(d.abs() < tiny, nudged, d)


def _mt(o, d, v0, e1, e2):
    """Möller-Trumbore on component tuples (each entry broadcasts).
    Returns (geometric hit, t, u, v); t is not yet masked."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a          # a == 0 -> inf -> the comparisons below reject
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
    return hit, t, u, v


def moller_trumbore(origin, direction, v0, e1, e2):
    """Batched Möller-Trumbore on [..., 3] operands that broadcast.
    Returns (hit bool, t, u, v); misses get t = +inf."""
    hit, t, u, v = _mt(origin.unbind(-1), direction.unbind(-1),
                       v0.unbind(-1), e1.unbind(-1), e2.unbind(-1))
    return hit, torch.where(hit, t, INF), u, v


def _finish(best_i, best_t, best_u, best_v, active):
    if active is not None:
        best_i = torch.where(active, best_i, -1)
    best_t = torch.where(best_i >= 0, best_t, INF)
    return best_i, best_t, best_u, best_v


def _init_best(origin, t_max):
    n = origin.shape[0]
    dev = origin.device
    best_t = (torch.full((n,), INF, device=dev) if t_max is None
              else t_max.to(torch.float32).clone())
    return (best_t, torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), torch.zeros(n, device=dev))


def merge_camtri(origin, direction, camtri, hit, active):
    """Merge the closest of (BVH hit, sensor-plane hit).  BVH scenes keep
    the sensor plane out of the tree; its triangles are tested densely
    after the traversal.  As in the JAX package, ``t_max`` does not cap
    this test."""
    best_i, best_t, best_u, best_v = hit
    c_hit, c_t, c_u, c_v = moller_trumbore(
        origin[:, None, :], direction[:, None, :],
        camtri["v0"][None], camtri["e1"][None], camtri["e2"][None],
    )  # [N, C]
    c_u = torch.where(c_hit, c_u, 0.0)
    c_v = torch.where(c_hit, c_v, 0.0)
    t_min, k = c_t.min(dim=1)
    better = t_min < best_t
    if active is not None:
        better &= active
    sel = k[:, None]
    return (
        torch.where(better, camtri["ids"][k], best_i),
        torch.where(better, t_min, best_t),
        torch.where(better, c_u.gather(1, sel)[:, 0], best_u),
        torch.where(better, c_v.gather(1, sel)[:, 0], best_v),
    )


def cell_index(x, cells: int):
    """Integer cells of ``x``, as the JAX package quantises:
    ``clip(x.astype(uint32), 0, cells - 1)``, where XLA's conversion sends
    NaN and negative values to 0 and saturates past the top.  int64, since
    torch's uint32 has few operations."""
    return torch.where(torch.isnan(x), 0.0, x).clamp(0, cells - 1).to(
        torch.int64)


def ray_order(key):
    """The stable argsort of ``key`` (``jnp.argsort`` is stable)."""
    return torch.sort(key, stable=True).indices


# rays per traversal call: bounds the walk's per-ray stacks (the walk's
# time is mostly its iterations', so the chunks are large)
CHUNK = 1 << 26


def _dense_hit(origin, direction, dense, active, t_max):
    """Closest hit of the dense triangles, as global triangle ids."""
    from .brute import brute_plain

    hi, ht, hu, hv = brute_plain(origin, direction, dense["tris"], active,
                                 t_max)
    gid = torch.where(hi >= 0, dense["ids"][hi.clamp(min=0).long()], -1)
    return gid.to(torch.int32), ht, hu, hv


def _intersect_chunk(origin, direction, scene, active, t_max, any_hit):
    if "brute" in scene:
        from .brute import brute_plain

        return brute_plain(origin, direction, scene["brute"]["tris"],
                           active=active, t_max=t_max)
    from .lbvh import intersect_lbvh

    hit = _dense_hit(origin, direction, scene["dense"], active, t_max)
    hit = intersect_lbvh(origin, direction, scene["lbvh"], hit, active,
                         t_max=t_max, any_hit=any_hit)
    return merge_camtri(origin, direction, scene["camtri"], hit, active)


def intersect_scene(origin, direction, scene, active=None, t_max=None,
                    any_hit=False):
    """The closest hit of each ray (``any_hit``: of a ray whose cast only
    asks whether something lies under ``t_max``, any hit under it; the
    integrator's visibility rules read the same answer from either).  No
    answer depends on the order of the rays, so none is sorted."""
    n = origin.shape[0]
    if active is not None and n > CHUNK:
        # only the active rays are cast; the others miss
        live = torch.nonzero(active).squeeze(1)
        hit = intersect_scene(origin[live], direction[live], scene, None,
                              None if t_max is None else t_max[live],
                              any_hit)
        out = (torch.full((n,), -1, dtype=torch.int32, device=origin.device),
               torch.full((n,), INF, device=origin.device),
               torch.zeros(n, device=origin.device),
               torch.zeros(n, device=origin.device))
        for o, h in zip(out, hit):
            o[live] = h.to(o.dtype)
        return out
    pick = lambda x, a, b: None if x is None else x[a:b]
    parts = [_intersect_chunk(origin[a:a + CHUNK], direction[a:a + CHUNK],
                              scene, pick(active, a, a + CHUNK),
                              pick(t_max, a, a + CHUNK), any_hit)
             for a in range(0, max(n, 1), CHUNK)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(4))
