"""Streaming fat-leaf traversal for large scenes (stream1): the CUDA kernel
in csrc/traverse_stream.cu, its packer, its plain PyTorch version
(``stream_plain``), and the fat-leaf cut and top tree it shares with the
stream2 kernel (ops/traverse_stream2.py).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_stream.py:_kernel``.  The
BVH is cut into a top tree and fat leaves: a node becomes a fat-leaf root
when its subtree holds at most ``16 * blocks_per_leaf`` SAH leaves and its
parent's subtree holds more (``_cut_mask``).  A ray walks the top tree with
a stack, nearer child first, the farther pushed with its entry distance.  At
a fat leaf it runs through the fat leaf's SAH leaves (its sub-leaves) in
preorder: each gets a slab test of its own AABB against the current best t,
and only then Möller-Trumbore on its triangles.  The winner is the
lexicographic minimum of (t, row), a row being the triangle's place in the
compact triangle rows, which list the gather walk's real slots in slot
order, so no visit order decides a tie.

Tables (``pack_stream``), all rows 16-byte multiples, read with 16-byte
loads:

* ``nodes`` [I, 16] f32: one 64-byte record per top-tree node, the BVH2
  kernel's layout (``traverse_bvh2.node_records``); a child reference >= 0
  is a top node, a fat leaf is ``~(first << FAT_BITS | count)``: its
  sub-leaves are ``subs`` rows first .. first + count - 1;
* ``subs`` [S, 8] f32: one 32-byte record per sub-leaf, contiguous within
  each fat leaf: its box min(3) max(3), then its first triangle row and its
  row count as int32 bits;
* ``tris`` [R, 12] f32: the compact triangle rows
  (``traverse_bvh2.triangle_rows``): no padding slot is read.

Departures from the TPU kernel, each for a TPU limit the card does not have:

* f32 boxes, not bf16-packed ones (``_pack_minmax``: the SMEM budget).
* no fat-leaf blocks: the TPU packer copies each fat leaf's 128 slots and
  their sub-leaf boxes into one [16, 128] block for its HBM -> VMEM DMA
  ring (``NBUF``), drained by one of three vectorised Möller-Trumbore
  drains (v1/v2/v3).  A lane reads a fat leaf's sub-leaf records and the
  rows of the sub-leaves it enters.
* no 4096-ray packets (``RAY_ROWS``), no ``MAX_BLOCKS_PER_CALL`` launch
  splitting, no Morton sort, and no SMEM-budget loop over
  ``blocks_per_leaf`` (the parameter stays, for tests).
* the (t, row) tie rule replaces the drains' largest-id pick within a
  block and first-drained order across blocks.

Kept: the cut, the sub-leaf box prefilter, inactive rays and caps; any-hit
stops after the first fat leaf that holds a hit under the cap.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import INF, WORK, _mt, box_entry, pop_stack, safe_inverse
from .traverse_bvh2 import leaf_spans, node_records, triangle_rows

STACK_SIZE = 64     # csrc/common.cuh:kWalkStack
SUB_SLOTS = 8       # triangles per SAH leaf (gather-walk leaf rows)
SUBTILES = 16       # SAH leaves per fat leaf and block
FAT_BITS = 6        # csrc/traverse_stream.cu:kFatBits: a fat leaf's count
PLAIN_CHUNK = 1 << 16   # rays per sub-leaf evaluation in the plain walks
MAX_TRI_ID = 1 << 24    # triangle ids travel as f32 in the leaf rows


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


def check_leaf_rows(leaf_packed):
    """Raise unless the gather walk's leaf rows hold 8 slots each and every
    triangle id survives them exactly (ids travel as f32)."""
    leaf_packed = np.asarray(leaf_packed)
    if leaf_packed.shape[1] != SUB_SLOTS * 10:
        raise ValueError(f"leaf rows must hold {SUB_SLOTS} slots")
    if leaf_packed.size and leaf_packed[:, 9::10].max() >= MAX_TRI_ID:
        raise ValueError("triangle ids past 2^24 do not survive the f32 "
                         "leaf rows")


def top_tree(node_packed, max_subleaves, stack_size):
    """The fat-leaf cut of the gather walk's node rows and the top tree
    above it.  Returns dict(nodebox [I, 12] f32 (both children's min(3)
    max(3)), childs [I, 2] i32 (>= 0 top node, -(f + 1) fat leaf f),
    leaf_nodes [L] (every SAH leaf's node index, in preorder), fat_ids [L]
    (the fat leaf holding each, non-decreasing), n_fat, depth (the most
    stack entries a walk of the top tree pushes)).  Raises when the
    root is a leaf, the scene is too small to cut, or the top tree is deeper
    than ``stack_size``."""
    node_packed = np.asarray(node_packed, dtype=np.float32)
    n_nodes = node_packed.shape[0]
    miss = node_packed[:, 6].astype(np.int64)
    leaf_id = node_packed[:, 7].astype(np.int64)
    is_leaf = leaf_id >= 0
    if is_leaf[0]:
        raise ValueError("the fat-leaf traversal needs an inner root")

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
    if max_depth > stack_size:
        raise ValueError(f"top tree depth {max_depth} exceeds the fat-leaf "
                         f"kernel's stack of {stack_size} entries")

    def encode(child):
        return np.where(cut_of[child] >= 0, -(cut_of[child] + 1),
                        top_ord[child])

    # the cut subtrees are disjoint, contiguous preorder ranges
    # [c, miss[c]) that cover every leaf: a leaf's fat leaf is the last cut
    # root at or before it
    leaf_nodes = np.nonzero(is_leaf)[0]
    fat_ids = np.searchsorted(cuts, leaf_nodes, side="right") - 1
    if not ((fat_ids >= 0).all()
            and (leaf_nodes < miss[cuts[fat_ids]]).all()):
        raise AssertionError("leaf outside every cut subtree")
    return dict(
        nodebox=np.ascontiguousarray(np.concatenate(
            [node_packed[left, 0:6], node_packed[right, 0:6]], axis=1)),
        childs=np.stack([encode(left), encode(right)], axis=1).astype(
            np.int32),
        leaf_nodes=leaf_nodes, fat_ids=fat_ids, n_fat=len(cuts),
        depth=max_depth)


def pack_stream(node_packed, leaf_packed, blocks_per_leaf=1):
    """Kernel tables from the gather walk's packed rows: dict(nodes [I, 16],
    subs [S, 8], tris [R, 12], all f32; see the module note).  The top
    tree and the cut are ``top_tree``'s, as for stream2; sub-leaves keep
    preorder, fat leaf after fat leaf.  Raises when the root is a leaf, the
    scene is too small to cut, the top tree is deeper than the kernel's
    stack, a triangle id is past what an f32 row holds exactly, or a fat
    leaf's reference does not fit 32 bits.
    """
    tris = triangle_rows(leaf_packed)
    max_subleaves = SUBTILES * blocks_per_leaf
    if max_subleaves >= 1 << FAT_BITS:
        raise ValueError(f"a fat leaf of {max_subleaves} sub-leaves needs "
                         f"more than {FAT_BITS} count bits")
    node_packed = np.asarray(node_packed, dtype=np.float32)
    tree = top_tree(node_packed, max_subleaves, STACK_SIZE)
    per_fat = np.bincount(tree["fat_ids"], minlength=tree["n_fat"])
    if (per_fat > max_subleaves).any() or (per_fat == 0).any():
        raise AssertionError("fat leaf over capacity or empty")
    fat_first = np.cumsum(per_fat) - per_fat
    if len(tree["leaf_nodes"]) << FAT_BITS >= 1 << 31:
        raise ValueError("too many sub-leaves for the fat-leaf references")
    first, count = leaf_spans(leaf_packed)

    leaf = node_packed[tree["leaf_nodes"], 7].astype(np.int64)
    subs = np.zeros((len(leaf), 8), dtype=np.float32)
    subs[:, 0:6] = node_packed[tree["leaf_nodes"], 0:6]
    subs.view(np.int32)[:, 6] = first[leaf]
    subs.view(np.int32)[:, 7] = count[leaf]

    fat_ref = ~((fat_first << FAT_BITS) | per_fat)
    childs = tree["childs"].astype(np.int64)
    refs = np.where(childs >= 0, childs,
                    fat_ref[np.maximum(-(childs + 1), 0)]).astype(np.int32)
    box = tree["nodebox"]
    return dict(nodes=node_records(box[:, 0:6], box[:, 6:12], refs[:, 0],
                                   refs[:, 1]),
                subs=subs, tris=tris)


def walk_top_tree(origin, direction, nodebox, childs, bt, best, active,
                  any_hit, visit):
    """The lockstep walk of a top tree (``nodebox`` [I, 12], both
    children's min(3) max(3); ``childs`` [I, 2], >= 0 a top node, else a
    fat leaf) that the plain versions of both fat-leaf kernels share: per
    ray, the nearer hit child first, the farther pushed with its entry
    distance, popped entries skipped when that distance exceeds the best t.
    ``visit(rays, fat)`` runs the fat-leaf test for rays (a chunk of at
    most PLAIN_CHUNK) at fat leaves ``fat`` (``-(child + 1)``),
    updating ``bt`` (best t) and ``best`` (best slot, -1 none) in place;
    with ``any_hit`` a ray stops after the first fat leaf that leaves it a
    hit."""
    dev = origin.device
    n = origin.shape[0]
    childs = childs.long()
    inv = safe_inverse(direction)
    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack_ref = torch.zeros(n, STACK_SIZE, dtype=torch.int64, device=dev)
    stack_t = torch.zeros(n, STACK_SIZE, device=dev)

    live = torch.nonzero(active).squeeze(1)
    while live.numel():
        r = ref[live]
        pop = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
        done = torch.zeros_like(pop)

        at_node = r >= 0
        ni = live[at_node]
        if ni.numel():
            WORK["boxes"] += 2 * ni.numel()
            nr = r[at_node]
            o_i, inv_i, bt_i = origin[ni], inv[ni], bt[ni]
            ta = box_entry(o_i, inv_i, nodebox[nr, 0:6], bt_i)
            tb = box_entry(o_i, inv_i, nodebox[nr, 6:12], bt_i)
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
            visit(ci, -(ref[ci] + 1))
        leaf_done = (best[li] >= 0) & any_hit
        done[~at_node] = leaf_done
        pop[~at_node] = ~leaf_done

        pi = live[pop]
        if pi.numel():
            done[pop] = ~pop_stack(pi, ref, sp, stack_ref, stack_t, bt)
        live = live[~done]


def stream_plain(origin, direction, tables, active=None, t_max=None,
                 any_hit=False):
    """Plain PyTorch version of the kernel on its own ``tables``
    (``pack_stream``): the same top-tree walk over the node records, the
    same sub-leaf records in order, box tests and Möller-Trumbore (in
    ``_mt``'s order), the same (t, row) rule and any-hit stop.  Rays
    advance in lockstep, one node or fat leaf per step; a fat leaf's
    sub-leaves run in order, each against the best t the previous ones
    left."""
    stream_plain.calls += 1
    dev = origin.device
    n = origin.shape[0]
    nodes, subs, tris = tables["nodes"], tables["subs"], tables["tris"]
    nodebox = torch.cat([nodes[:, [0, 2, 8, 1, 3, 9]],
                         nodes[:, [4, 6, 10, 5, 7, 11]]], dim=1)
    childs = nodes.view(torch.int32)[:, 12:14]
    sub_first = subs.view(torch.int32)[:, 6].long()
    sub_count = subs.view(torch.int32)[:, 7].long()
    fat_mask = (1 << FAT_BITS) - 1
    fat_codes = ~childs[childs < 0].long()
    width = max(int((fat_codes & fat_mask).max()) if fat_codes.numel()
                else 0, 1)
    kk = torch.arange(SUB_SLOTS, device=dev)

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    bt = (torch.full((n,), INF, device=dev) if t_max is None
          else t_max.to(torch.float32).clone())
    bs = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    inv = safe_inverse(direction)

    def visit(ci, code):
        start = code >> FAT_BITS
        count = code & fat_mask
        o, d, iv = origin[ci], direction[ci], inv[ci]
        oc = tuple(c[:, None] for c in o.unbind(-1))
        dc = tuple(c[:, None] for c in d.unbind(-1))
        for j in range(width):
            valid = j < count
            sub = torch.where(valid, start + j, 0)
            cur_t, cur_s = bt[ci], bs[ci]
            enter = valid & (box_entry(o, iv, subs[sub, 0:6], cur_t) < INF)
            first, rows = sub_first[sub], sub_count[sub]
            real = (kk < rows[:, None]) & enter[:, None]       # [k, 8]
            row = torch.where(real, first[:, None] + kk, 0)
            tr = tris[row]                                     # [k, 8, 12]
            WORK["boxes"] += int(valid.sum())
            WORK["triangles"] += int(real.sum())
            hit, t, u, v = _mt(oc, dc, tr[:, :, 0:3].unbind(-1),
                               tr[:, :, 4:7].unbind(-1),
                               tr[:, :, 8:11].unbind(-1))
            ok = hit & real
            t = torch.where(ok, t, INF)
            t_best = t.amin(1)
            k = torch.where((t == t_best[:, None]) & ok, kk,
                            SUB_SLOTS).amin(1).clamp(max=SUB_SLOTS - 1)
            slot = first + k
            better = ok.any(1) & ((t_best < cur_t) | (
                (t_best == cur_t) & (slot < cur_s)))
            sel = k[:, None]
            bt[ci] = torch.where(better, t_best, cur_t)
            bs[ci] = torch.where(better, slot, cur_s)
            bi[ci] = torch.where(better, tr[:, :, 3].gather(1, sel)[:, 0]
                                 .int(), bi[ci])
            bu[ci] = torch.where(better, u.gather(1, sel)[:, 0], bu[ci])
            bv[ci] = torch.where(better, v.gather(1, sel)[:, 0], bv[ci])

    walk_top_tree(origin, direction, nodebox, childs, bt, bs, act, any_hit,
                  visit)
    hit = bs >= 0
    return (torch.where(hit, bi, -1), torch.where(hit, bt, INF),
            torch.where(hit, bu, 0.0), torch.where(hit, bv, 0.0))


stream_plain.calls = 0


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_KERNEL_TABLES = (("nodes", torch.float32, (16,)),
                  ("subs", torch.float32, (8,)),
                  ("tris", torch.float32, (12,)))


def intersect_stream(origin, direction, scene, active=None, t_max=None,
                     any_hit=False):
    """Closest hit (or, with ``any_hit``, a hit under ``t_max``) of the
    scene's BVH triangles through its ``stream`` tables; the sensor plane
    is not in the tree.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise if the scene has no ``stream`` tables or the kernel cannot
    launch).
    """
    if "stream" not in scene:
        raise ValueError("scene has no stream tables: build it with "
                         "CLIVE2_STREAM_IMPL=1 or traversal='stream'")
    tables = scene["stream"]
    if origin.device.type == "cpu":
        return stream_plain(origin, direction, tables, active=active,
                            t_max=t_max, any_hit=any_hit)
    from .. import kernels

    kernels.check_tables(tables, _KERNEL_TABLES, "stream")
    rays = kernels.ray_args(origin, direction, active, t_max)
    args = kernels.aligned_tables(tables, _KERNEL_TABLES, origin.device,
                                  "stream")
    out = kernels.hit_outputs(origin)
    if rays.n:
        # the persistent warps' ray counter, zeroed by clive2_stream on the
        # launch's stream
        counter = torch.empty(1, dtype=torch.int64, device=origin.device)
        kernels.call("clive2_stream", origin.device, *rays.pointers(),
                     *map(kernels.ptr, args), kernels.ptr(counter),
                     int(any_hit), *map(kernels.ptr, out))
        intersect_stream.launches += 1
    return out


intersect_stream.launches = 0


def kernel_info(any_hit=False):
    """What the CUDA runtime reports of the kernel: registers per thread,
    static shared bytes per block, local bytes per thread, resident blocks
    per SM, SMs."""
    from .. import kernels

    return kernels.resources("clive2_stream_info", any_hit)
