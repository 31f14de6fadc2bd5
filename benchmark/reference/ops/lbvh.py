"""The reference's own acceleration structure: a linear BVH over the mesh
files' triangles, built on the host from the triangles' Morton order, and
its closest-hit walk in plain PyTorch.  It shares nothing with the
program's builders or traversals; only the Moller-Trumbore arithmetic
(``intersect._mt``) is the same, so a triangle's hit rounds alike on both
sides and only the choice between exact ties can differ.

Layout: ``LEAF`` consecutive triangles of the Morton order form a leaf; the
leaves, padded to a power of two, are the bottom level of a complete binary
tree in heap order (node 1 is the root, node i has children 2i and 2i + 1,
leaf j is node L + j).  Boxes are rounded outward to f32, and a box is
entered while its entry distance is at most ``cull_bound`` of the ray's best
t, so rounding can only add visits, never lose a hit.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import INF, _finish, _mt, cull_bound, safe_inverse

LEAF = 16        # triangles per leaf


def _morton3(q):
    """21-bit integer cells [M, 3] -> 63-bit Morton codes (x major)."""
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
        for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                            (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                            (2, 0x1249249249249249)):
            v = (v | (v << np.uint64(shift))) & np.uint64(mask)
        return v

    return ((spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1))
            | spread(q[:, 2]))


def build_lbvh(v0, e1, e2, ids, device):
    """The tree over triangles (v0, e1, e2) [M, 3] f32 with global ids
    [M].  Returns a dict of tensors on ``device``: ``box`` [2L, 6] (min,
    max; nodes 0 and those over padding only are never entered),
    ``live`` [2L] bool, ``tris`` [L, LEAF, 9] and ``ids`` [L, LEAF] (-1
    pads), ``leaves`` (L)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    m = v0.shape[0]
    corners = np.stack([v0, v0 + e1, v0 + e2]).astype(np.float64)   # [3, M, 3]
    tmin, tmax = corners.min(0), corners.max(0)
    cen = (tmin + tmax) * 0.5
    lo, hi = cen.min(0), cen.max(0)
    q = np.clip((cen - lo) / np.maximum(hi - lo, 1e-30) * (1 << 21),
                0, (1 << 21) - 1).astype(np.int64)
    order = np.argsort(_morton3(q), kind="stable")

    n_leaves = 1 << max(0, int(np.ceil(np.log2(max(1, -(-m // LEAF))))))
    slots = n_leaves * LEAF
    sel = np.full(slots, -1, np.int64)
    sel[:m] = order
    ok = sel >= 0
    src = np.where(ok, sel, 0)
    tris = np.zeros((slots, 9), np.float32)
    tris[:, 0:3] = v0[src]
    tris[:, 3:6] = e1[src]
    tris[:, 6:9] = e2[src]
    tris[~ok] = 0.0
    tri_ids = np.where(ok, np.asarray(ids)[src], -1).astype(np.int32)

    lmin = np.where(ok[:, None], tmin[src], np.inf).reshape(n_leaves, LEAF, 3)
    lmax = np.where(ok[:, None], tmax[src], -np.inf).reshape(n_leaves, LEAF,
                                                             3)
    box_min = np.full((2 * n_leaves, 3), np.inf)
    box_max = np.full((2 * n_leaves, 3), -np.inf)
    box_min[n_leaves:] = lmin.min(1)
    box_max[n_leaves:] = lmax.max(1)
    level = n_leaves
    while level > 1:                   # parents of nodes [level, 2 level)
        half = level // 2
        kids = np.arange(level, 2 * level)
        box_min[half:level] = box_min[kids].reshape(half, 2, 3).min(1)
        box_max[half:level] = box_max[kids].reshape(half, 2, 3).max(1)
        level = half
    live = np.isfinite(box_min).all(1)
    live[0] = False
    # outward to f32, plus a relative margin for the slab test's rounding
    box_min = np.where(live[:, None], box_min, 0.0)
    box_max = np.where(live[:, None], box_max, 0.0)
    pad = 1e-6 * (np.abs(box_min) + np.abs(box_max) + 1.0)
    bmin = np.nextafter((box_min - pad).astype(np.float32),
                        np.float32(-np.inf))
    bmax = np.nextafter((box_max + pad).astype(np.float32),
                        np.float32(np.inf))
    t = lambda a: torch.as_tensor(a, device=device)
    return dict(box=t(np.concatenate([bmin, bmax], 1)), live=t(live),
                tris=t(tris.reshape(n_leaves, LEAF, 9)),
                ids=t(tri_ids.reshape(n_leaves, LEAF)), leaves=n_leaves)


def _entry(o, inv, box, bt):
    """Entry distance of rays o/inv [m, 3] into boxes [m, 6] capped at
    ``cull_bound(bt)``, or inf when missed."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tf = torch.minimum(torch.maximum(t0, t1).amin(-1), cull_bound(bt))
    return torch.where(tn <= tf, tn, INF)


def intersect_lbvh(origin, direction, tree, hit, active=None, t_max=None,
                   any_hit=False):
    """Closest hit of the tree's triangles, or ``hit`` (tri, t, u, v: the
    dense triangles' answer) where that is closer, capped at ``t_max``.
    Equal t keeps the earlier answer.  ``any_hit`` ends a ray at its first
    hit under the cap."""
    n = origin.shape[0]
    dev = origin.device
    best_i, best_t, best_u, best_v = (x.clone() for x in hit)
    cap = (torch.full((n,), INF, device=dev) if t_max is None
           else t_max.to(torch.float32))
    best_t = torch.where(best_i >= 0, best_t, cap)
    inv = safe_inverse(direction)
    box, live_node = tree["box"], tree["live"]
    n_leaves = tree["leaves"]

    # a pop and two pushes a level: the stack never holds more than the
    # tree's depth plus one entries
    depth = max(1, int(n_leaves).bit_length())
    stack_n = torch.zeros((n, depth + 1), dtype=torch.int32, device=dev)
    stack_t = torch.full((n, depth + 1), INF, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    root_t = _entry(origin, inv, box[1].expand(n, 6), best_t)
    go = root_t < INF
    if active is not None:
        go &= active
    if any_hit:
        go &= best_i < 0
    stack_n[:, 0] = 1
    stack_t[:, 0] = root_t
    sp[go] = 1

    rays = torch.nonzero(go).squeeze(1)
    while rays.numel():
        top = sp[rays] - 1
        node = stack_n[rays, top].long()
        te = stack_t[rays, top]
        sp[rays] = top
        bt = best_t[rays]
        keep = te <= cull_bound(bt)        # else the entry lies past a hit
        leaf = keep & (node >= n_leaves)
        inner = keep & (node < n_leaves)
        # a leaf: its triangles against the ray
        lr = rays[leaf]
        if lr.numel():
            lid = node[leaf] - n_leaves
            row = tree["tris"][lid]                          # [k, LEAF, 9]
            o = origin[lr]
            d = direction[lr]
            ok, t, u, v = _mt(
                tuple(c[:, None] for c in o.unbind(-1)),
                tuple(c[:, None] for c in d.unbind(-1)),
                row[..., 0:3].unbind(-1), row[..., 3:6].unbind(-1),
                row[..., 6:9].unbind(-1))
            ids = tree["ids"][lid]
            t = torch.where(ok & (ids >= 0), t, INF)
            t_leaf, k = t.min(dim=1)
            lbt = bt[leaf]
            better = t_leaf < lbt
            sel = k[:, None]
            best_t[lr] = torch.where(better, t_leaf, lbt)
            best_i[lr] = torch.where(better, ids.gather(1, sel)[:, 0],
                                     best_i[lr])
            best_u[lr] = torch.where(better, u.gather(1, sel)[:, 0],
                                     best_u[lr])
            best_v[lr] = torch.where(better, v.gather(1, sel)[:, 0],
                                     best_v[lr])
            if any_hit:
                sp[lr[better]] = 0
        # an inner node: push its entered children, the nearer on top
        ir = rays[inner]
        if ir.numel():
            kids = node[inner][:, None] * 2 + torch.arange(2, device=dev)
            ibt = bt[inner]
            o = origin[ir][:, None].expand(-1, 2, 3).reshape(-1, 3)
            iv = inv[ir][:, None].expand(-1, 2, 3).reshape(-1, 3)
            te2 = _entry(o, iv, box[kids.reshape(-1)],
                         ibt[:, None].expand(-1, 2).reshape(-1)).reshape(-1, 2)
            te2 = torch.where(live_node[kids], te2, INF)
            near = (te2[:, 1] < te2[:, 0]).long()
            order = torch.stack([1 - near, near], 1)          # far, near
            kid_o = kids.gather(1, order)
            te_o = te2.gather(1, order)
            base = sp[ir]
            for j in range(2):
                enter = te_o[:, j] < INF
                r = ir[enter]
                pos = base[enter]
                stack_n[r, pos] = kid_o[enter, j].to(torch.int32)
                stack_t[r, pos] = te_o[enter, j]
                base = base + enter.long()
            sp[ir] = base
        rays = rays[sp[rays] > 0]
    return _finish(best_i, best_t, best_u, best_v, active)

