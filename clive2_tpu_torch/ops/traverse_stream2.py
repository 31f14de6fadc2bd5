"""Fat-leaf traversal for large scenes: the CUDA kernel in
csrc/traverse_stream2.cu, its packer, and its plain PyTorch version
(``stream2_plain``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_stream2.py:_kernel``.  The
BVH is cut into a top tree and fat leaves: a node becomes a fat-leaf root
when its subtree holds at most ``cols // 8`` SAH leaves and its parent's
subtree holds more (``traverse_stream._cut_mask``).  A ray walks the top
tree with a stack and tests every triangle of each fat leaf it enters
through Möller-Trumbore written as bilinear forms of the ray features
``[d, m, o', 1]`` (``o'`` the origin shifted by the scene centre ``ctr``,
``m = o' x d``) and per-triangle features::

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
from .intersect import INF, _mt
# the cut, the top tree and its walk are the stream1 kernel's
# (ops/traverse_stream.py), as in the JAX package, where stream2 imports
# ``_cut_mask`` from traverse_stream
from .traverse_stream import _cut_mask  # noqa: F401
from .traverse_stream import check_leaf_rows, top_tree, walk_top_tree

STACK_SIZE = 64     # csrc/traverse_stream2.cu:kStackSize
SUB_SLOTS = 8       # triangles per SAH leaf (gather-walk leaf rows)
LANES = 128         # fat-leaf capacity per block: cols = 128 * blocks_per_leaf
N_FEAT = 20         # 19 feature coefficients + 1 zero pad (80-byte rows)
CAP_CLAMP = 1e30    # INF caps become this finite sentinel


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
    the root is a leaf, the scene is too small to cut, the top tree is
    deeper than the kernel's stack, or a triangle id is past what an f32
    leaf row holds exactly.
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    leaf_packed = np.asarray(leaf_packed, dtype=np.float32)
    check_leaf_rows(leaf_packed)
    tree = top_tree(node_packed, LANES * blocks_per_leaf // SUB_SLOTS,
                    STACK_SIZE)
    nodebox, childs = tree["nodebox"], tree["childs"]

    # slots: every filled leaf slot in preorder leaf order; the cut
    # subtrees are contiguous preorder ranges, so each fat leaf's slots are
    # one contiguous range
    leaf_nodes, fat_ids = tree["leaf_nodes"], tree["fat_ids"]
    leaf_id = node_packed[leaf_nodes, 7].astype(np.int64)
    rows = leaf_packed.reshape(-1, SUB_SLOTS, 10)[leaf_id]
    filled = rows[:, :, 9] >= 0                      # [L, 8]
    per_fat = np.zeros(tree["n_fat"], dtype=np.int64)
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
    fat_start = tables["fat_start"]
    width = max(int((fat_start[1:] - fat_start[:-1]).max()), 1)

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    cap = (torch.full((n,), INF, device=dev) if t_max is None
           else t_max.to(torch.float32))
    bt = torch.where(cap < CAP_CLAMP, cap, CAP_CLAMP)
    bc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    osh = origin - tables["ctr"]
    ox, oy, oz = osh.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    m = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                     ox * dy - oy * dx], dim=1)

    def visit(ci, f):
        t_leaf, slot = _leaf_best(tables, f, direction[ci].unbind(-1),
                                  m[ci].unbind(-1), osh[ci].unbind(-1),
                                  width)
        cur_t, cur_c = bt[ci], bc[ci]
        better = (slot >= 0) & ((t_leaf < cur_t) | (
            (t_leaf == cur_t) & (slot < cur_c)))
        bt[ci] = torch.where(better, t_leaf, cur_t)
        bc[ci] = torch.where(better, slot, cur_c)

    walk_top_tree(origin, direction, tables, bt, bc, act, any_hit, visit)
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


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_KERNEL_TABLES = (("nodebox", torch.float32, (12,)),
                  ("childs", torch.int32, (2,)),
                  ("feat", torch.float32, (N_FEAT,)),
                  ("fat_start", torch.int32, ()),
                  ("slot_tri", torch.int32, ()),
                  ("slot_mt", torch.float32, (9,)), ("ctr", torch.float32, ()))


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

    kernels.check_tables(tables, _KERNEL_TABLES, "stream2")
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
