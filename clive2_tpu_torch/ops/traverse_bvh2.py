"""Binary BVH traversal for scenes above 256 triangles: the CUDA kernel in
csrc/traverse_bvh2.cu, its packer, and its plain PyTorch version (the gather
walk, ``intersect.intersect_bvh_packed``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_pallas2.py:_kernel``.  The
kernel runs persistent warps that fetch rays from a counter, reads 64-byte
node records and 48-byte triangle rows with 16-byte loads, and keeps its
stack in shared memory (see the note in the .cu file).  The node records
and triangle rows are built here (``node_records``, ``triangle_rows``) and
also serve the streaming kernel's top tree (ops/traverse_stream.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import intersect_bvh_packed

STACK_SIZE = 64     # csrc/common.cuh:kWalkStack
LEAF_SLOTS = 8      # slots per leaf of the gather walk's rows
LEAF_BITS = 4       # csrc/traverse_bvh2.cu:kLeafBits: a leaf's slot count
MAX_ID = 1 << 24    # triangle ids are stored in f32 rows


def leaf_spans(leaf_packed):
    """(first, count) of each leaf of the gather walk's rows in the compact
    triangle rows: its real slots (tri id >= 0), in slot order."""
    tri = np.asarray(leaf_packed).reshape(-1, LEAF_SLOTS, 10)[:, :, 9]
    count = (tri >= 0).sum(1)
    first = np.cumsum(count) - count
    return first.astype(np.int64), count.astype(np.int64)


def triangle_rows(leaf_packed):
    """[R, 12] f32: one row per real slot (tri id >= 0) of the gather walk's
    leaf rows, in slot order: v0 and the tri id, e1 and 0, e2 and 0.
    Raises when a triangle id does not fit an f32 row (2^24) or the rows
    overflow a 2^31 reference."""
    leaves = np.asarray(leaf_packed, dtype=np.float32)
    if leaves.shape[1] != LEAF_SLOTS * 10:
        raise ValueError(f"leaf rows must hold {LEAF_SLOTS} slots")
    leaves = leaves.reshape(-1, LEAF_SLOTS, 10)
    if (leaves[:, :, 9] >= MAX_ID).any():
        raise ValueError(f"triangle ids must stay below 2^24 = {MAX_ID} to "
                         "be exact in the kernels' f32 rows")
    rows = leaves[leaves[:, :, 9] >= 0]                    # [R, 10]
    if len(rows) << LEAF_BITS >= 1 << 31:
        raise ValueError("too many triangles for the kernels' leaf "
                         "references")
    tris = np.zeros((len(rows), 12), dtype=np.float32)
    tris[:, 0:3], tris[:, 3] = rows[:, 0:3], rows[:, 9]
    tris[:, 4:7], tris[:, 8:11] = rows[:, 3:6], rows[:, 6:9]
    return tris


def node_records(box_a, box_b, ref_a, ref_b):
    """[I, 16] f32 node records of inner nodes with children A and B
    (boxes [I, 6] min(3) max(3), references [I] int32): the boxes
    interleaved as (A.lo.x, A.hi.x, A.lo.y, A.hi.y), (B.lo.x, B.hi.x,
    B.lo.y, B.hi.y), (A.lo.z, A.hi.z, B.lo.z, B.hi.z), then the two
    references as int32 bits and two zeros."""
    nodes = np.zeros((len(box_a), 16), dtype=np.float32)
    for col, (box, k) in enumerate(
            [(box_a, 0), (box_a, 3), (box_a, 1), (box_a, 4),
             (box_b, 0), (box_b, 3), (box_b, 1), (box_b, 4),
             (box_a, 2), (box_a, 5), (box_b, 2), (box_b, 5)]):
        nodes[:, col] = box[:, k]
    nodes.view(np.int32)[:, 12] = ref_a
    nodes.view(np.int32)[:, 13] = ref_b
    return nodes


def pack_bvh2(node_packed, leaf_packed):
    """Kernel tables from the gather walk's packed rows.

    In the preorder threaded tree, inner node i's left child is i + 1 and
    its right child is the left child's miss link.  Inner nodes are
    renumbered compactly.  Returns dict of

    * ``nodes`` [I, 16] f32: the kernel's node records (``node_records``);
      a reference >= 0 is an inner id, a leaf is ~(first << LEAF_BITS |
      count) (``leaf_spans``);
    * ``tris`` [R, 12] f32: the triangle rows (``triangle_rows``).

    Raises when the root is a leaf, the tree is deeper than the kernel's
    stack, or a triangle id does not fit an f32 row (2^24).
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    n = node_packed.shape[0]
    miss = node_packed[:, 6].astype(np.int64)
    leaf_id = node_packed[:, 7].astype(np.int64)
    is_leaf = leaf_id >= 0
    if is_leaf[0]:
        raise ValueError("the BVH2 kernel needs an inner root node")
    tris = triangle_rows(leaf_packed)

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

    first, count = leaf_spans(leaf_packed)
    inner_ord = np.full(n, -1, dtype=np.int64)
    inner_ord[inner] = np.arange(len(inner))
    leaf_ref = ~((first << LEAF_BITS) | count)

    def encode(child):
        return np.where(is_leaf[child], leaf_ref[leaf_id[child]],
                        inner_ord[child]).astype(np.int32)

    nodes = node_records(node_packed[left, 0:6], node_packed[right, 0:6],
                         encode(left), encode(right))
    return dict(nodes=nodes, tris=tris)


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_TABLES = (("nodes", torch.float32, (16,)), ("tris", torch.float32, (12,)))


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
    kernels.check_tables(scene["bvh2"], _TABLES, "bvh2")
    rays = kernels.ray_args(origin, direction, active, t_max)
    tables = kernels.aligned_tables(scene["bvh2"], _TABLES, origin.device,
                                    "bvh2")
    out = kernels.hit_outputs(origin)
    if not rays.n:
        return out
    # the persistent warps' ray counter, zeroed by clive2_bvh2 on the
    # launch's stream
    counter = torch.empty(1, dtype=torch.int64, device=origin.device)
    kernels.call("clive2_bvh2", origin.device, *rays.pointers(),
                 *map(kernels.ptr, tables), kernels.ptr(counter),
                 int(any_hit), *map(kernels.ptr, out))
    intersect_bvh2.launches += 1
    return out


intersect_bvh2.launches = 0


def kernel_info(any_hit=False):
    """What the CUDA runtime reports of the kernel: registers per thread,
    static shared bytes per block, local bytes per thread, resident blocks
    per SM, SMs."""
    from .. import kernels

    return kernels.resources("clive2_bvh2_info", any_hit)
