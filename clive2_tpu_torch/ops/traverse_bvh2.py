"""Binary BVH traversal for scenes above 256 triangles: the CUDA kernel in
csrc/traverse_bvh2.cu, its packer, and its plain PyTorch version (the gather
walk, ``intersect.intersect_bvh_packed``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_pallas2.py:_kernel``.  The
kernel walks node records that hold both children's AABBs, with a
per-thread stack (see the note in the .cu file).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .intersect import intersect_bvh_packed

STACK_SIZE = 64     # csrc/traverse_bvh2.cu:kStackSize
LEAF_SLOTS = 8      # csrc/traverse_bvh2.cu:kLeafSlots


def pack_bvh2(node_packed, leaf_packed):
    """Kernel tables from the gather walk's packed rows.

    In the preorder threaded tree, inner node i's left child is i + 1 and
    its right child is the left child's miss link.  Inner nodes are
    renumbered compactly; a child reference >= 0 is an inner id, < 0 is
    leaf -(id + 1).  Returns dict(nodebox [I, 12] f32, childs [I, 2] i32,
    leaves [L, 8, 10] f32) and raises when the root is a leaf or the tree
    is deeper than the kernel's stack.
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    leaf_packed = np.asarray(leaf_packed, dtype=np.float32)
    n = node_packed.shape[0]
    miss = node_packed[:, 6].astype(np.int64)
    leaf_id = node_packed[:, 7].astype(np.int64)
    is_leaf = leaf_id >= 0
    if is_leaf[0]:
        raise ValueError("the BVH2 kernel needs an inner root node")
    if leaf_packed.shape[1] != LEAF_SLOTS * 10:
        raise ValueError(f"leaf rows must hold {LEAF_SLOTS} slots")

    inner = np.nonzero(~is_leaf)[0]
    left = inner + 1
    right = miss[left]

    depth = np.zeros(n, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    parent[left] = inner
    parent[right] = inner
    for i in range(1, n):                  # preorder: parents come first
        depth[i] = depth[parent[i]] + 1
    max_depth = int(depth.max(initial=0))
    if max_depth > STACK_SIZE:
        raise ValueError(
            f"BVH depth {max_depth} exceeds the BVH2 kernel's stack of "
            f"{STACK_SIZE} entries")

    inner_ord = np.full(n, -1, dtype=np.int64)
    inner_ord[inner] = np.arange(len(inner))

    def encode(child):
        return np.where(is_leaf[child], -(leaf_id[child] + 1),
                        inner_ord[child])

    childs = np.stack([encode(left), encode(right)], axis=1).astype(np.int32)
    nodebox = np.concatenate(
        [node_packed[left, 0:6], node_packed[right, 0:6]], axis=1)
    leaves = leaf_packed.reshape(-1, LEAF_SLOTS, 10)
    return dict(nodebox=np.ascontiguousarray(nodebox), childs=childs,
                leaves=np.ascontiguousarray(leaves))


def intersect_bvh2(origin, direction, scene, active=None, t_max=None,
                   any_hit=False):
    """Closest hit (or, with ``any_hit``, some hit under ``t_max``) of the
    scene's BVH triangles; the sensor plane is not in the tree.

    CPU tensors take the plain version, the gather walk over
    ``scene["bvh"]``; CUDA tensors launch the kernel on ``scene["bvh2"]``
    (and raise if it cannot launch).
    """
    if origin.device.type == "cpu":
        return intersect_bvh_packed(origin, direction, scene["bvh"],
                                    active=active, t_max=t_max)
    from .. import kernels

    if "bvh2" not in scene:
        raise ValueError("scene has no BVH2 tables: build it with "
                         "device='cuda'")
    rays = kernels.ray_args(origin, direction, active, t_max)
    tables = scene["bvh2"]
    nodebox, childs, leaves = (
        kernels.on_device(tables[k].contiguous(), origin.device, k)
        for k in ("nodebox", "childs", "leaves"))
    out = kernels.hit_outputs(origin)
    if rays.n:
        kernels.call("clive2_bvh2", origin.device, *rays.pointers(),
                     kernels.ptr(nodebox), kernels.ptr(childs),
                     kernels.ptr(leaves), ctypes.c_int(int(any_hit)),
                     *map(kernels.ptr, out))
        intersect_bvh2.launches += 1
    return out


intersect_bvh2.launches = 0
