"""Binary BVH traversal for scenes above 256 triangles: the CUDA kernel in
csrc/traverse_bvh2.cu, its packer, and its plain PyTorch version (the gather
walk, ``intersect.intersect_bvh_packed``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_pallas2.py:_kernel``.  The
kernel runs persistent warps that fetch rays from a counter, reads 64-byte
node records and 48-byte triangle rows with 16-byte loads, and keeps its
stack in shared memory (see the note in the .cu file).  The first design,
one thread per ray over the ``nodebox``/``childs``/``leaves`` tables
(csrc/traverse_bvh2_first.cu), stays as the ``"pr1"`` instance for the A/B.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .intersect import intersect_bvh_packed

STACK_SIZE = 64     # csrc/traverse_bvh2.cu:kStackSize, and the first design's
LEAF_SLOTS = 8      # csrc/traverse_bvh2_first.cu:kLeafSlots
LEAF_BITS = 4       # csrc/traverse_bvh2.cu:kLeafBits: a leaf's slot count
MAX_ID = 1 << 24    # triangle ids are stored in f32 rows
# the instances of the kernel: the default (persistent warps) and the two
# A/B instances chip_smoke.py times beside it
INSTANCES = (None, "pr1", "one_per_ray")


def leaf_spans(leaf_packed):
    """(first, count) of each leaf of the gather walk's rows in the compact
    triangle rows: its real slots (tri id >= 0), in slot order."""
    tri = np.asarray(leaf_packed).reshape(-1, LEAF_SLOTS, 10)[:, :, 9]
    count = (tri >= 0).sum(1)
    first = np.cumsum(count) - count
    return first.astype(np.int64), count.astype(np.int64)


def pack_bvh2(node_packed, leaf_packed):
    """Kernel tables from the gather walk's packed rows.

    In the preorder threaded tree, inner node i's left child is i + 1 and
    its right child is the left child's miss link.  Inner nodes are
    renumbered compactly.  Returns dict of

    * ``nodes`` [I, 16] f32: the kernel's node records, the children's
      boxes interleaved as (A.lo.x, A.hi.x, A.lo.y, A.hi.y), (B.lo.x,
      B.hi.x, B.lo.y, B.hi.y), (A.lo.z, A.hi.z, B.lo.z, B.hi.z), then the
      two child references as int32 bits and two zeros; a reference >= 0 is
      an inner id, a leaf is ~(first << LEAF_BITS | count) (``leaf_spans``);
    * ``tris`` [R, 12] f32: one row per real slot, in slot order: v0 and
      the tri id, e1 and 0, e2 and 0;
    * the first design's tables: ``nodebox`` [I, 12] f32 (both children's
      min(3) max(3)), ``childs`` [I, 2] i32 (a leaf is -(leaf id + 1)) and
      ``leaves`` [L, 8, 10] f32 (the gather walk's leaf rows).

    Raises when the root is a leaf, the tree is deeper than the kernel's
    stack, or a triangle id does not fit an f32 row (2^24).
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

    leaves = leaf_packed.reshape(-1, LEAF_SLOTS, 10)
    if (leaves[:, :, 9] >= MAX_ID).any():
        raise ValueError(f"triangle ids must stay below 2^24 = {MAX_ID} to "
                         "be exact in the BVH2 kernel's f32 rows")
    first, count = leaf_spans(leaf_packed)
    rows = leaves[leaves[:, :, 9] >= 0]                    # [R, 10]
    if len(rows) << LEAF_BITS >= 1 << 31:
        raise ValueError("too many triangles for the BVH2 kernel's leaf "
                         "references")
    tris = np.zeros((len(rows), 12), dtype=np.float32)
    tris[:, 0:3], tris[:, 3] = rows[:, 0:3], rows[:, 9]
    tris[:, 4:7], tris[:, 8:11] = rows[:, 3:6], rows[:, 6:9]

    inner_ord = np.full(n, -1, dtype=np.int64)
    inner_ord[inner] = np.arange(len(inner))
    leaf_ref = ~((first << LEAF_BITS) | count)

    def encode(child, leaf_code):
        return np.where(is_leaf[child], leaf_code[leaf_id[child]],
                        inner_ord[child]).astype(np.int32)

    leaf_id_ref = -(np.arange(len(leaves)) + 1)
    childs = np.stack([encode(left, leaf_id_ref), encode(right, leaf_id_ref)],
                      axis=1)
    box_a, box_b = node_packed[left, 0:6], node_packed[right, 0:6]
    nodebox = np.concatenate([box_a, box_b], axis=1)
    nodes = np.zeros((len(inner), 16), dtype=np.float32)
    for col, (box, k) in enumerate(
            [(box_a, 0), (box_a, 3), (box_a, 1), (box_a, 4),
             (box_b, 0), (box_b, 3), (box_b, 1), (box_b, 4),
             (box_a, 2), (box_a, 5), (box_b, 2), (box_b, 5)]):
        nodes[:, col] = box[:, k]
    nodes.view(np.int32)[:, 12] = encode(left, leaf_ref)
    nodes.view(np.int32)[:, 13] = encode(right, leaf_ref)
    return dict(nodes=nodes, tris=tris,
                nodebox=np.ascontiguousarray(nodebox), childs=childs,
                leaves=np.ascontiguousarray(leaves))


# the tables each instance reads, in argument order: (name, dtype, shape
# past dim 0)
_TABLES = (("nodes", torch.float32, (16,)), ("tris", torch.float32, (12,)))
_FIRST_TABLES = (("nodebox", torch.float32, (12,)),
                 ("childs", torch.int32, (2,)),
                 ("leaves", torch.float32, (LEAF_SLOTS, 10)))


def intersect_bvh2(origin, direction, scene, active=None, t_max=None,
                   any_hit=False, instance=None):
    """Closest hit (or, with ``any_hit``, some hit under ``t_max``) of the
    scene's BVH triangles; the sensor plane is not in the tree.

    CPU tensors take the plain version, the gather walk over
    ``scene["bvh"]``; CUDA tensors launch the kernel on ``scene["bvh2"]``
    (and raise if it cannot launch).  ``instance`` picks the kernel for an
    A/B: None (the persistent kernel), ``"pr1"`` (the first design) or
    ``"one_per_ray"`` (the persistent kernel's walk with one lane per ray
    and no ray fetch).  Those two give the gather walk's ids on every ray;
    ``"pr1"`` resolves exact ties in t by its visit order instead.
    """
    if instance not in INSTANCES:
        raise ValueError(f"unknown BVH2 instance {instance!r}: expected one "
                         f"of {INSTANCES}")
    if origin.device.type == "cpu":
        return intersect_bvh_packed(origin, direction, scene["bvh"],
                                    active=active, t_max=t_max)
    from .. import kernels

    if "bvh2" not in scene:
        raise ValueError("scene has no BVH2 tables: build it with "
                         "device='cuda'")
    spec = _FIRST_TABLES if instance == "pr1" else _TABLES
    kernels.check_tables(scene["bvh2"], spec, "bvh2")
    rays = kernels.ray_args(origin, direction, active, t_max)
    tables = [kernels.on_device(scene["bvh2"][k].contiguous(), origin.device,
                                k) for k, _, _ in spec]
    for (k, _, _), t in zip(spec, tables):
        if t.data_ptr() % 16:
            raise ValueError(f"bvh2 table {k} must be 16-byte aligned")
    out = kernels.hit_outputs(origin)
    if not rays.n:
        return out
    if instance == "pr1":
        kernels.call("clive2_bvh2_first", origin.device, *rays.pointers(),
                     *map(kernels.ptr, tables), ctypes.c_int(int(any_hit)),
                     *map(kernels.ptr, out))
    else:
        # the persistent warps' ray counter, zeroed by clive2_bvh2 on the
        # launch's stream
        persistent = instance is None
        counter = (torch.empty(1, dtype=torch.int64, device=origin.device)
                   if persistent else None)
        kernels.call("clive2_bvh2", origin.device, *rays.pointers(),
                     *map(kernels.ptr, tables),
                     None if counter is None else kernels.ptr(counter),
                     ctypes.c_int(int(any_hit)), ctypes.c_int(int(persistent)),
                     *map(kernels.ptr, out))
    intersect_bvh2.launches += 1
    return out


intersect_bvh2.launches = 0


def kernel_info(any_hit=False, instance=None):
    """What the CUDA runtime reports of the kernel instance (the default or
    ``"one_per_ray"``): registers per thread, static shared bytes per
    block, local bytes per thread, resident blocks per SM, SMs."""
    from .. import kernels

    out = (ctypes.c_int * 5)()
    rc = kernels.load().clive2_bvh2_info(int(any_hit), int(instance is None),
                                         out)
    if rc:
        raise RuntimeError(f"clive2_bvh2_info failed with CUDA error {rc}")
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "blocks_per_sm", "sms"), out))
