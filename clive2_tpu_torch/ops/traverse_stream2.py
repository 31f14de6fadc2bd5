"""Fat-leaf traversal for large scenes: the CUDA kernel in
csrc/traverse_stream2.cu, its packer, and its plain PyTorch version
(``stream2_plain``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_stream2.py:_kernel``.  The
BVH is cut into a top tree and fat leaves: a node becomes a fat-leaf root
when its subtree holds at most ``cols // 8`` SAH leaves and its parent's
subtree holds more (``_cut_mask``).  A ray walks the top tree with a stack
and tests every triangle of each fat leaf it enters through Möller-Trumbore
written as bilinear forms of the ray features ``[d, m, o', 1]`` (``o'`` the
origin shifted by the scene centre ``ctr``, ``m = o' x d``) and
per-triangle features::

    a   = d . (-n)                    n = e1 x e2, v0' = v0 - ctr
    u_n = d . (v0' x e2) + m . e2
    v_n = d . -(v0' x e1) + m . (-e1)
    t_n = o' . n - v0' . n            u, v, t = (u_n, v_n, t_n) / a

A slot passes when ``min(u, v, 1-u-v) >= 0`` and ``t > DELTA``; the winner is
the lexicographic minimum of (t, slot) among the passing slots with t under
the cap, which no visit order changes.  Then t, u and v are recomputed by
plain Möller-Trumbore on the winner's own original-coordinate row.

Departures from the TPU kernel, each for a TPU limit the card does not have:

* f32 boxes, not bf16-packed ones: ``_pack_minmax`` and the 32 B/node
  layout fit the top tree into ~1 MB of SMEM; here it sits in global memory
  and L2.
* f32 triangle features, not the bf16x6 residual split (the split exists
  because the MXU multiplies bf16).  Only the 19 coefficients that are not
  structurally zero are stored, in the fixed order above (a: 3, u_n: 6,
  v_n: 6, t_n: 4), so the kernel and this file sum the same terms.
* slots are stored compactly, fat leaf after fat leaf (``fat_start``), with
  no empty padding slots, and each slot keeps its original-coordinate
  v0/e1/e2 and its global triangle id.  The TPU packer indexes its u, v, t
  recovery arrays (built from the world soup, which has no sensor-plane
  triangles) by global id, so it reads the wrong triangle in every scene
  with a camera; reading the slot's own row cannot.
* the (t, slot) tie rule replaces the TPU kernel's order-dependent fold,
  and there is no Morton sort of the rays: the answer does not depend on
  ray order.
* one thread per ray with its own stack replaces 4096-ray packets, the DMA
  ring and the chunk masks; the SMEM-budget loop over ``blocks_per_leaf``
  is gone (the parameter stays for tests).

Kept: the cut, the child encoding (>= 0 top node, ``-(f + 1)`` fat leaf f),
the centre shift (it conditions the bilinear forms), inactive rays and
caps: an INF cap is clamped to 1e30 as the TPU wrapper does, and any-hit
stops after the first fat leaf that holds a hit under the cap.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import DELTA
from .intersect import INF, _mt, safe_inverse

STACK_SIZE = 64     # csrc/traverse_stream2.cu:kStackSize
SUB_SLOTS = 8       # triangles per SAH leaf (gather-walk leaf rows)
LANES = 128         # fat-leaf capacity per block: cols = 128 * blocks_per_leaf
N_FEAT = 20         # 19 feature coefficients + 1 zero pad (80-byte rows)
CAP_CLAMP = 1e30    # INF caps become this finite sentinel
PLAIN_CHUNK = 1 << 16   # rays per fat-leaf evaluation in stream2_plain


def _cut_mask(miss, leaf_id, max_subleaves):
    """A node is a fat-leaf root iff its subtree holds <= max_subleaves SAH
    leaves and its parent's holds more.  ``miss``/``leaf_id`` are the
    preorder threaded tree's arrays (the subtree of i spans [i, miss[i]),
    inner node i's children are i + 1 and miss[i + 1]).  Returns
    (cut mask, leaves under each node)."""
    miss = np.asarray(miss, dtype=np.int64)
    is_leaf = np.asarray(leaf_id) >= 0
    n_nodes = len(miss)
    leaf_prefix = np.concatenate([[0], np.cumsum(is_leaf)])
    leaves_under = leaf_prefix[miss] - leaf_prefix[np.arange(n_nodes)]
    if leaves_under[0] <= max_subleaves:
        raise ValueError("scene too small for the fat-leaf traversal")
    inner = np.nonzero(~is_leaf)[0]
    parent = np.zeros(n_nodes, dtype=np.int64)       # the root's stays 0
    parent[inner + 1] = inner
    parent[miss[inner + 1]] = inner
    cut_mask = ((leaves_under <= max_subleaves)
                & (leaves_under[parent] > max_subleaves))
    return cut_mask, leaves_under


def triangle_features(v0, e1, e2, ctr):
    """[..., 19] f32 bilinear coefficients of triangles v0/e1/e2 [..., 3]
    (module docstring order: a 0-2, u_n 3-8, v_n 9-14, t_n 15-18)."""
    v0s = v0 - ctr
    nrm = np.cross(e1, e2)
    return np.concatenate([
        -nrm,
        np.cross(v0s, e2), e2,
        -np.cross(v0s, e1), -e1,
        nrm, -np.sum(v0s * nrm, axis=-1, keepdims=True),
    ], axis=-1).astype(np.float32)


def pack_stream2(node_packed, leaf_packed, blocks_per_leaf=1):
    """Kernel tables from the gather walk's packed rows.

    Returns dict(nodebox [I, 12] f32 (both children's min(3) max(3)),
    childs [I, 2] i32, feat [S, 20] f32, fat_start [F + 1] i32 (fat leaf f
    holds slots fat_start[f]:fat_start[f + 1]), slot_tri [S] i32 global
    triangle ids, slot_mt [S, 9] f32 v0 e1 e2, ctr [3] f32).  Raises when
    the root is a leaf, the scene is too small to cut, or the top tree is
    deeper than the kernel's stack.
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    leaf_packed = np.asarray(leaf_packed, dtype=np.float32)
    n_nodes = node_packed.shape[0]
    miss = node_packed[:, 6].astype(np.int64)
    leaf_id = node_packed[:, 7].astype(np.int64)
    is_leaf = leaf_id >= 0
    if is_leaf[0]:
        raise ValueError("the fat-leaf traversal needs an inner root")
    if leaf_packed.shape[1] != SUB_SLOTS * 10:
        raise ValueError(f"leaf rows must hold {SUB_SLOTS} slots")
    max_subleaves = LANES * blocks_per_leaf // SUB_SLOTS

    cut_mask, _ = _cut_mask(miss, leaf_id, max_subleaves)
    cuts = np.nonzero(cut_mask)[0]                   # preorder fat-leaf order
    cut_of = np.full(n_nodes, -1, dtype=np.int64)
    cut_of[cuts] = np.arange(len(cuts))

    # top tree: inner nodes above every cut, renumbered compactly
    under = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(under, cuts, 1)
    np.add.at(under, miss[cuts], -1)
    under = np.cumsum(under[:-1]) > 0                # includes cut roots
    top = np.nonzero(~is_leaf & ~under)[0]
    top_ord = np.full(n_nodes, -1, dtype=np.int64)
    top_ord[top] = np.arange(len(top))
    left = top + 1
    right = miss[left]

    depth = np.zeros(n_nodes, dtype=np.int64)       # top-tree levels
    for i, l, r in zip(top, left, right):            # preorder: parents first
        depth[l] = depth[r] = depth[i] + 1
    max_depth = int(depth[top].max(initial=0)) + 1
    if max_depth > STACK_SIZE:
        raise ValueError(f"top tree depth {max_depth} exceeds the fat-leaf "
                         f"kernel's stack of {STACK_SIZE} entries")

    def encode(child):
        return np.where(cut_of[child] >= 0, -(cut_of[child] + 1),
                        top_ord[child])

    childs = np.stack([encode(left), encode(right)], axis=1).astype(np.int32)
    nodebox = np.concatenate(
        [node_packed[left, 0:6], node_packed[right, 0:6]], axis=1)

    # slots: every filled leaf slot in preorder leaf order; the cut
    # subtrees are contiguous preorder ranges, so each fat leaf's slots are
    # one contiguous range
    leaf_nodes = np.nonzero(is_leaf)[0]
    fat_ids = np.searchsorted(cuts, leaf_nodes, side="right") - 1
    if not ((fat_ids >= 0).all()
            and (leaf_nodes < miss[cuts[fat_ids]]).all()):
        raise AssertionError("leaf outside every cut subtree")
    rows = leaf_packed.reshape(-1, SUB_SLOTS, 10)[leaf_id[leaf_nodes]]
    filled = rows[:, :, 9] >= 0                      # [L, 8]
    per_fat = np.zeros(len(cuts), dtype=np.int64)
    np.add.at(per_fat, fat_ids, filled.sum(axis=1))
    fat_start = np.concatenate([[0], np.cumsum(per_fat)])
    if (per_fat > LANES * blocks_per_leaf).any():
        raise AssertionError("fat leaf over capacity")
    slots = rows[filled]                             # [S, 10]

    ctr = (0.5 * (node_packed[0, 0:3] + node_packed[0, 3:6])).astype(
        np.float32)
    feat = np.zeros((len(slots), N_FEAT), dtype=np.float32)
    feat[:, :19] = triangle_features(slots[:, 0:3], slots[:, 3:6],
                                     slots[:, 6:9], ctr)
    return dict(nodebox=np.ascontiguousarray(nodebox), childs=childs,
                feat=feat, fat_start=fat_start.astype(np.int32),
                slot_tri=slots[:, 9].astype(np.int32),
                slot_mt=np.ascontiguousarray(slots[:, 0:9]), ctr=ctr)


def _box_entry(o, inv, box, bt):
    """Slab test of [m, 6] boxes (min(3) max(3)): entry distance, or inf
    when missed or beyond bt (csrc/traverse_stream2.cu:box_entry)."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    tmin = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tmax = torch.minimum(torch.maximum(t0, t1).amin(-1), bt)
    return torch.where(tmin <= tmax, tmin, INF)


def _leaf_best(tables, f, d, m, osh, width):
    """Best passing slot of fat leaf ``f`` [k] for rays with features
    d/m/osh (tuples of [k] tensors): returns (t, slot), t = inf and slot
    -1 where no slot passes.  The sums run in the kernel's order."""
    fat_start, feat = tables["fat_start"], tables["feat"]
    start = fat_start[f].long()
    count = fat_start[f + 1].long() - start
    col = torch.arange(width, device=f.device)
    valid = col < count[:, None]
    idx = torch.where(valid, start[:, None] + col, 0)
    c = feat[idx].unbind(-1)                        # 20 x [k, width]
    dx, dy, dz = (x[:, None] for x in d)
    mx, my, mz = (x[:, None] for x in m)
    ox, oy, oz = (x[:, None] for x in osh)
    a = c[0] * dx + c[1] * dy + c[2] * dz
    u_n = (c[3] * dx + c[4] * dy + c[5] * dz + c[6] * mx + c[7] * my
           + c[8] * mz)
    v_n = (c[9] * dx + c[10] * dy + c[11] * dz + c[12] * mx + c[13] * my
           + c[14] * mz)
    t_n = c[15] * ox + c[16] * oy + c[17] * oz + c[18]
    finv = 1.0 / a
    u = u_n * finv
    v = v_n * finv
    t = t_n * finv
    w = 1.0 - u - v
    ok = (u >= 0.0) & (v >= 0.0) & (w >= 0.0) & (t > DELTA) & valid
    t = torch.where(ok, t, INF)
    t_best = t.amin(1)
    first = torch.where((t == t_best[:, None]) & ok, col, width).amin(1)
    slot = torch.where(ok.any(1), start + first, -1)
    return t_best, slot


def stream2_plain(origin, direction, tables, active=None, t_max=None,
                  any_hit=False):
    """Plain PyTorch version of the kernel: the same per-ray stack walk
    (nearer child first, the farther pushed with its entry distance,
    popped entries skipped when that distance exceeds the best t), the
    same fat-leaf arithmetic and (t, slot) rule, the same any-hit stop and
    the same exact recomputation on the winner.  Rays advance in lockstep,
    one node or fat leaf per step."""
    stream2_plain.calls += 1
    dev = origin.device
    n = origin.shape[0]
    nodebox, childs = tables["nodebox"], tables["childs"].long()
    fat_start = tables["fat_start"]
    width = max(int((fat_start[1:] - fat_start[:-1]).max()), 1)

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    cap = (torch.full((n,), INF, device=dev) if t_max is None
           else t_max.to(torch.float32))
    bt = torch.where(cap < CAP_CLAMP, cap, CAP_CLAMP)
    bc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv = safe_inverse(direction)
    osh = origin - tables["ctr"]
    ox, oy, oz = osh.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    m = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                     ox * dy - oy * dx], dim=1)

    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack_ref = torch.zeros(n, STACK_SIZE, dtype=torch.int64, device=dev)
    stack_t = torch.zeros(n, STACK_SIZE, device=dev)
    levels = torch.arange(STACK_SIZE, device=dev)

    live = torch.nonzero(act).squeeze(1)
    while live.numel():
        r = ref[live]
        pop = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
        done = torch.zeros_like(pop)

        at_node = r >= 0
        ni = live[at_node]
        if ni.numel():
            nr = r[at_node]
            o_i, inv_i, bt_i = origin[ni], inv[ni], bt[ni]
            ta = _box_entry(o_i, inv_i, nodebox[nr, 0:6], bt_i)
            tb = _box_entry(o_i, inv_i, nodebox[nr, 6:12], bt_i)
            ca, cb = childs[nr, 0], childs[nr, 1]
            ha, hb = ta < INF, tb < INF
            both = ha & hb
            a_near = ta <= tb
            pi, psp = ni[both], sp[ni[both]]
            stack_ref[pi, psp] = torch.where(a_near, cb, ca)[both]
            stack_t[pi, psp] = torch.where(a_near, tb, ta)[both]
            sp[pi] = psp + 1
            ref[ni] = torch.where(both, torch.where(a_near, ca, cb),
                                  torch.where(ha, ca, cb))
            pop[at_node] = ~(ha | hb)

        li = live[~at_node]
        for k in range(0, li.numel(), PLAIN_CHUNK):
            ci = li[k:k + PLAIN_CHUNK]
            t_leaf, slot = _leaf_best(
                tables, -(ref[ci] + 1), direction[ci].unbind(-1),
                m[ci].unbind(-1), osh[ci].unbind(-1), width)
            cur_t, cur_c = bt[ci], bc[ci]
            better = (slot >= 0) & ((t_leaf < cur_t) | (
                (t_leaf == cur_t) & (slot < cur_c)))
            bt[ci] = torch.where(better, t_leaf, cur_t)
            bc[ci] = torch.where(better, slot, cur_c)
        leaf_done = (bc[li] >= 0) & any_hit
        done[~at_node] = leaf_done
        pop[~at_node] = ~leaf_done

        # pop the topmost entry that can still hold a better hit
        pi = live[pop]
        if pi.numel():
            ok = (levels < sp[pi, None]) & (stack_t[pi] <= bt[pi, None])
            j = (ok * (levels + 1)).amax(1) - 1
            found = j >= 0
            ref[pi[found]] = stack_ref[pi[found], j[found]]
            sp[pi] = j.clamp(min=0)
            done[pop] = ~found
        live = live[~done]

    hit = bc >= 0
    row = tables["slot_mt"][bc.clamp(min=0)]
    _, t, u, v = _mt(origin.unbind(-1), direction.unbind(-1),
                     row[:, 0:3].unbind(-1), row[:, 3:6].unbind(-1),
                     row[:, 6:9].unbind(-1))
    tri = tables["slot_tri"][bc.clamp(min=0)]
    return (torch.where(hit, tri, -1).to(torch.int32),
            torch.where(hit, t, INF), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0))


stream2_plain.calls = 0


# the kernel's tables in argument order: (name, dtype, row width or 0)
_KERNEL_TABLES = (("nodebox", torch.float32, 12), ("childs", torch.int32, 2),
                  ("feat", torch.float32, N_FEAT),
                  ("fat_start", torch.int32, 0), ("slot_tri", torch.int32, 0),
                  ("slot_mt", torch.float32, 9), ("ctr", torch.float32, 0))


def intersect_stream2(origin, direction, scene, active=None, t_max=None,
                      any_hit=False):
    """Closest hit (or, with ``any_hit``, a hit under ``t_max``) of the
    scene's BVH triangles through its ``stream2`` tables; the sensor plane
    is not in the tree.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise if it cannot launch).
    """
    tables = scene["stream2"]
    if origin.device.type == "cpu":
        return stream2_plain(origin, direction, tables, active=active,
                             t_max=t_max, any_hit=any_hit)
    from .. import kernels

    for k, dtype, width in _KERNEL_TABLES:
        t = tables[k]
        if t.dtype != dtype or (width and (t.dim() != 2
                                           or t.shape[1] != width)):
            raise ValueError(f"stream2 table {k} must be {dtype} with rows "
                             f"of {width}, got {tuple(t.shape)} {t.dtype}")
    rays = kernels.ray_args(origin, direction, active, t_max)
    args = [kernels.on_device(tables[k].contiguous(), origin.device, k)
            for k, _, _ in _KERNEL_TABLES]
    out = kernels.hit_outputs(origin)
    if rays.n:
        kernels.call("clive2_stream2", origin.device, *rays.pointers(),
                     *map(kernels.ptr, args), ctypes.c_int(int(any_hit)),
                     *map(kernels.ptr, out))
        intersect_stream2.launches += 1
    return out


intersect_stream2.launches = 0
