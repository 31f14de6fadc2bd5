"""Ray-scene intersection: slab test, Möller-Trumbore, the gather walk, and
the one dispatch every cast goes through (port of clive2_tpu/ops/intersect.py).

Contract of every intersector here and of the CUDA kernels behind
``intersect_scene``: rays ``origin``/``direction`` [N, 3] f32, an optional
``active`` [N] bool mask (inactive rays miss) and an optional per-ray
``t_max`` [N] cap (hits at or beyond it are ignored).  Returns
(tri_id [N] i32, t, u, v): misses report tri_id -1 and t = inf, and hits
closer than DELTA are rejected as self-hits.  ``intersect_scene`` may
Morton-sort a cast's rays by ``morton_key`` before the traversal and put
the results back in the caller's order.

The Möller-Trumbore arithmetic is written out per component in one fixed
order (``_mt``) and shared by every plain version, and the kernels in
``csrc/`` use the same order, so with contraction off a kernel and its
plain version round identically.
"""

from __future__ import annotations

import collections

import torch

from ..constants import DELTA

INF = float("inf")

# work the plain walks did since it was cleared: AABB slab tests ("boxes"),
# Möller-Trumbore tests ("triangles") and bilinear slot tests ("slots");
# chip_smoke.py derives the kernels' operation counts from it
WORK = collections.Counter()


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


def ray_box_test(origin, inv_dir, bmin, bmax, t_max):
    """Slab test with early-out against the current best t.
    origin/inv_dir/bmin/bmax [..., 3]; returns bool [...]."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tmin_f = torch.clamp(tmin.amax(-1), min=0.0)
    tmax_f = torch.minimum(tmax.amin(-1), cull_bound(t_max))
    return tmin_f <= tmax_f


def box_entry(o, inv, box, bt):
    """Slab test of [..., 6] boxes (min(3) max(3)) for rays o/inv [..., 3]
    capped at bt [...]: the entry distance, or inf when missed or beyond
    ``cull_bound(bt)`` (csrc/common.cuh:box_entry)."""
    t0 = (box[..., 0:3] - o) * inv
    t1 = (box[..., 3:6] - o) * inv
    tmin = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tmax = torch.minimum(torch.maximum(t0, t1).amin(-1), cull_bound(bt))
    return torch.where(tmin <= tmax, tmin, INF)


def pop_stack(rays, ref, sp, stack_ref, stack_t, bt):
    """One lockstep pop for ``rays`` of the plain walks: the topmost stack
    entry whose entry distance is at most the culling bound of the ray's
    best t becomes its next ``ref``, and the entries above it are dropped,
    as the kernels' pop loop does.  Returns the bool mask of the rays that
    found one."""
    levels = torch.arange(stack_t.shape[1], device=rays.device)
    ok = (levels < sp[rays, None]) & (stack_t[rays]
                                      <= cull_bound(bt[rays, None]))
    j = (ok * (levels + 1)).amax(1) - 1
    found = j >= 0
    ref[rays[found]] = stack_ref[rays[found], j[found]].to(ref.dtype)
    sp[rays] = j.clamp(min=0)
    return found


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


def intersect_bvh_packed(origin, direction, bvh, active=None, t_max=None):
    """Gather walk over the miss-link threaded BVH's packed rows.

    node rows [n, 8]: min(3) max(3) miss leaf_id; leaf rows [L, K*10]:
    K slots of v0(3) e1(3) e2(3) tri(1), tri -1 = padding.  Each ray
    follows one node pointer in preorder (hit inner -> next node, else ->
    miss link) until it passes the last node.  This is the CPU path of
    every BVH scene and the plain version of the BVH2 kernel.
    """
    intersect_bvh_packed.calls += 1
    node_packed = bvh["node_packed"]
    leaf_packed = bvh["leaf_packed"]
    n_nodes = node_packed.shape[0]
    k = leaf_packed.shape[1] // 10
    inv_dir = safe_inverse(direction)

    node = torch.zeros(origin.shape[0], dtype=torch.int64,
                       device=origin.device)
    if active is not None:
        node = torch.where(active, node, n_nodes)
    best_t, best_i, best_u, best_v = _init_best(origin, t_max)

    # only live rays are advanced: per-ray results equal the lockstep
    # walk's, since rays never interact
    live = torch.nonzero(node < n_nodes).squeeze(1)
    while live.numel():
        nd = node[live]
        o = origin[live]
        d = direction[live]
        bt = best_t[live]
        nrow = node_packed[nd]                            # [m, 8]
        miss = nrow[:, 6].to(torch.int64)
        lid = nrow[:, 7].to(torch.int64)
        box_hit = ray_box_test(o, inv_dir[live], nrow[:, 0:3], nrow[:, 3:6],
                               bt)
        is_leaf = lid >= 0
        do_leaf = box_hit & is_leaf
        WORK["boxes"] += live.numel()

        lrow = leaf_packed[lid.clamp(min=0)].reshape(-1, k, 10)
        ti = lrow[:, :, 9].to(torch.int32)
        hit, t, u, v = _mt(
            tuple(c[:, None] for c in o.unbind(-1)),
            tuple(c[:, None] for c in d.unbind(-1)),
            lrow[:, :, 0:3].unbind(-1), lrow[:, :, 3:6].unbind(-1),
            lrow[:, :, 6:9].unbind(-1),
        )
        valid = hit & (ti >= 0) & do_leaf[:, None]
        WORK["triangles"] += int(((ti >= 0) & do_leaf[:, None]).sum())
        t = torch.where(valid, t, INF)
        t_leaf, kk = t.min(dim=1)
        better = t_leaf < bt
        sel = kk[:, None]
        best_t[live] = torch.where(better, t_leaf, bt)
        best_i[live] = torch.where(better, ti.gather(1, sel)[:, 0],
                                   best_i[live])
        best_u[live] = torch.where(better, u.gather(1, sel)[:, 0],
                                   best_u[live])
        best_v[live] = torch.where(better, v.gather(1, sel)[:, 0],
                                   best_v[live])

        nxt = torch.where(box_hit & ~is_leaf, nd + 1, miss)
        node[live] = nxt
        live = live[nxt < n_nodes]
    return _finish(best_i, best_t, best_u, best_v, None)


intersect_bvh_packed.calls = 0


def pack_gather_walk(bvh, leafs):
    """Pack the gather walk's per-step lookups into one node row and one
    leaf row (same layout as the JAX package's tables).

    node rows: min(3) max(3) miss leaf_id   (floats; ids < 2^24)
    leaf rows: K slots of v0(3) e1(3) e2(3) tri(1)
    """
    import numpy as np

    n = bvh.n_nodes
    node_packed = np.zeros((n, 8), dtype=np.float32)
    node_packed[:, 0:3] = bvh.node_mins
    node_packed[:, 3:6] = bvh.node_maxes
    node_packed[:, 6] = bvh.miss
    node_packed[:, 7] = bvh.leaf_id

    k = leafs["v0"].shape[1]
    lcount = leafs["v0"].shape[0]
    leaf_packed = np.zeros((lcount, k, 10), dtype=np.float32)
    leaf_packed[:, :, 0:3] = leafs["v0"]
    leaf_packed[:, :, 3:6] = leafs["e1"]
    leaf_packed[:, :, 6:9] = leafs["e2"]
    leaf_packed[:, :, 9] = leafs["tri_index"]
    return dict(
        node_packed=node_packed,
        leaf_packed=leaf_packed.reshape(lcount, k * 10),
    )


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


def _spread10(x):
    """The 10 low bits of ``x`` spread to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_key(origin, direction, lo, hi, active=None):
    """Packet-coherence sort key of each ray (port of
    traverse_pallas2._morton_key, bit for bit): the 30-bit 3D Morton code
    of the ray's entry point into the scene box ``lo``/``hi`` (the origin
    itself when it lies inside), major, then the x and y direction octant
    bits, minor.  Camera rays share an origin but their entry points tile
    the box; bounce rays start on surfaces, where entry == origin.
    Inactive rays key 0xFFFFFFFF and sort last.  [N] int64 holding the
    JAX package's uint32 values."""
    octant = ((direction[:, 0] > 0).to(torch.int64) * 4
              + (direction[:, 1] > 0).to(torch.int64) * 2
              + (direction[:, 2] > 0).to(torch.int64))
    inv = safe_inverse(direction)
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    t_enter = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    entry = origin + direction * torch.nan_to_num(
        t_enter, nan=0.0, posinf=0.0, neginf=0.0)[:, None]
    q = cell_index((entry - lo) / torch.clamp(hi - lo, min=1e-6) * 1024,
                   1024)
    m = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
         | _spread10(q[:, 2]))
    key = (m << 2) | (octant >> 1)
    if active is not None:
        key = torch.where(active, key, 0xFFFFFFFF)
    return key


def ray_order(key):
    """The stable argsort of ``key`` (``jnp.argsort`` is stable)."""
    return torch.sort(key, stable=True).indices


def unsort(order, values):
    """Each tensor of ``values`` (in the order ``order`` gave) scattered back
    to the caller's order."""
    return tuple(torch.empty_like(v).index_copy_(0, order, v)
                 for v in values)


def traversal_of(scene):
    """The name of the traversal table ``intersect_scene`` takes for a BVH
    scene (``wide``, ``bvh2``, ``stream2`` or ``stream``), or None for the
    gather walk of a scene without one."""
    return next((k for k in ("wide", "bvh2", "stream2", "stream")
                 if k in scene), None)


def intersect_scene(origin, direction, scene, active=None, t_max=None,
                    any_hit=False, sort=False):
    """The dispatch behind every cast, keyed by the scene's tables.

    In the JAX package's order: a ``brute`` table (scenes of at most 256
    triangles) goes to the dense brute-force intersector; a ``wide`` table
    to the BVH8 traversal, a ``bvh2`` table to the BVH2 traversal, a
    ``stream2`` table to the fat-leaf traversal and a ``stream`` table to
    the streaming traversal; a scene with none of them to the BVH2
    traversal's CPU path, the gather walk.  BVH scenes then merge the
    sensor-plane triangles (``camtri``).  Each intersector runs its CUDA
    kernel on CUDA tensors and its plain version on CPU tensors.
    ``any_hit`` lets the traversals stop at the first hit under ``t_max``
    (visibility casts whose cap excludes the target); the exhaustive paths
    return the closest hit, which is a valid answer too.

    ``sort`` hands the traversal its rays in ``morton_key`` order, keyed on
    the root box its table keeps (``lo``/``hi``), and scatters the hits
    back to the caller's order; no traversal's answer depends on the
    order, only its coherence.  ``None`` sorts exactly the streaming
    tables' casts (``stream``, ``stream2``), as the JAX package's default
    does.  The brute test and a scene without a traversal table (the
    gather walk) ignore it.
    """
    if "brute" in scene:
        from .brute import intersect_brute

        return intersect_brute(origin, direction, scene["brute"]["tris"],
                               active=active, t_max=t_max)
    name = traversal_of(scene)
    if name == "wide":
        from .traverse_wide import intersect_wide as traverse
    elif name in ("bvh2", None):
        from .traverse_bvh2 import intersect_bvh2 as traverse
    elif name == "stream2":
        from .traverse_stream2 import intersect_stream2 as traverse
    else:
        from .traverse_stream import intersect_stream as traverse
    if sort is None:
        sort = name in ("stream", "stream2")
    if sort and name is not None:
        table = scene[name]
        order = ray_order(morton_key(origin, direction, table["lo"],
                                     table["hi"], active))
        pick = lambda x: None if x is None else x[order]
        hit = unsort(order, traverse(
            origin[order], direction[order], scene, active=pick(active),
            t_max=pick(t_max), any_hit=any_hit))
    else:
        hit = traverse(origin, direction, scene, active=active, t_max=t_max,
                       any_hit=any_hit)
    return merge_camtri(origin, direction, scene["camtri"], hit, active)
