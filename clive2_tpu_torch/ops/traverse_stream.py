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
and only then Möller-Trumbore on its 8 slots.  The winner is the
lexicographic minimum of (t, slot), a slot being the triangle's position in
the gather walk's leaf rows (``leaf * 8 + k``), so no visit order decides a
tie.

The tables point into what the scene already holds: ``sub_node`` lists
each fat leaf's SAH leaves as node indices of the gather walk's
``node_packed`` (their boxes and leaf ids), whose ``leaf_packed`` rows hold
the triangles.  Only the top tree and two index arrays are new.

Departures from the TPU kernel, each for a TPU limit the card does not have:

* f32 boxes, not bf16-packed ones (``_pack_minmax``: the SMEM budget).
* no fat-leaf blocks: the TPU packer copies each fat leaf's 128 slots and
  their sub-leaf boxes into one [16, 128] block for its HBM -> VMEM DMA
  ring (``NBUF``), drained by one of three vectorised Möller-Trumbore
  drains (v1/v2/v3).  One thread per ray reads the leaf rows in place.
* no 4096-ray packets (``RAY_ROWS``), no ``MAX_BLOCKS_PER_CALL`` launch
  splitting, no Morton sort, and no SMEM-budget loop over
  ``blocks_per_leaf`` (the parameter stays, for tests).
* the (t, slot) tie rule replaces the drains' largest-id pick within a
  block and first-drained order across blocks.

Kept: the cut, the child encoding (>= 0 top node, ``-(f + 1)`` fat leaf f),
the sub-leaf box prefilter, inactive rays and caps; any-hit stops after
the first fat leaf that holds a hit under the cap.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .intersect import INF, WORK, _mt, box_entry, pop_stack, safe_inverse

STACK_SIZE = 64     # csrc/traverse_stream.cu:kStackSize
SUB_SLOTS = 8       # triangles per SAH leaf (gather-walk leaf rows)
SUBTILES = 16       # SAH leaves per fat leaf and block
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
    """Kernel tables from the gather walk's packed rows.

    Returns dict(nodebox [I, 12] f32, childs [I, 2] i32 (the top tree, as
    for stream2), fat_start [F + 1] i32 and sub_node [L] i32: fat leaf f
    holds the SAH leaves whose node rows are
    ``sub_node[fat_start[f]:fat_start[f + 1]]``, in preorder).  Raises
    when the root is a leaf, the scene is too small to cut, the top tree
    is deeper than the kernel's stack, or a triangle id is past what an f32
    leaf row holds exactly.
    """
    check_leaf_rows(leaf_packed)
    max_subleaves = SUBTILES * blocks_per_leaf
    tree = top_tree(node_packed, max_subleaves, STACK_SIZE)
    per_fat = np.bincount(tree["fat_ids"], minlength=tree["n_fat"])
    if (per_fat > max_subleaves).any() or (per_fat == 0).any():
        raise AssertionError("fat leaf over capacity or empty")
    return dict(nodebox=tree["nodebox"], childs=tree["childs"],
                fat_start=np.concatenate([[0], np.cumsum(per_fat)]).astype(
                    np.int32),
                sub_node=tree["leaf_nodes"].astype(np.int32))


def walk_top_tree(origin, direction, tables, bt, best, active, any_hit,
                  visit):
    """The lockstep walk of the top tree that the plain versions of both
    fat-leaf kernels share: per ray, the nearer hit child first, the farther
    pushed with its entry distance, popped entries skipped when that
    distance exceeds the best t.  ``visit(rays, fat)`` runs the fat-leaf
    test for rays (a chunk of at most PLAIN_CHUNK) at fat leaves ``fat``,
    updating ``bt`` (best t) and ``best`` (best slot, -1 none) in place;
    with ``any_hit`` a ray stops after the first fat leaf that leaves it a
    hit."""
    dev = origin.device
    n = origin.shape[0]
    nodebox, childs = tables["nodebox"], tables["childs"].long()
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


def stream_plain(origin, direction, tables, bvh, active=None, t_max=None,
                 any_hit=False):
    """Plain PyTorch version of the kernel on ``tables`` (``pack_stream``)
    and the gather walk's rows ``bvh``: the same top-tree walk, the same
    sub-leaf order, box tests and Möller-Trumbore (in ``_mt``'s order), the
    same (t, slot) rule and any-hit stop.  Rays advance in lockstep, one
    node or fat leaf per step; a fat leaf's sub-leaves run in order, each
    against the best t the previous ones left."""
    stream_plain.calls += 1
    dev = origin.device
    n = origin.shape[0]
    node_packed = bvh["node_packed"]
    leaves = bvh["leaf_packed"].reshape(-1, SUB_SLOTS, 10)
    fat_start = tables["fat_start"].long()
    sub_node = tables["sub_node"].long()
    width = max(int((fat_start[1:] - fat_start[:-1]).max()), 1)
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

    def visit(ci, f):
        start = fat_start[f]
        count = fat_start[f + 1] - start
        o, d, iv = origin[ci], direction[ci], inv[ci]
        oc = tuple(c[:, None] for c in o.unbind(-1))
        dc = tuple(c[:, None] for c in d.unbind(-1))
        for j in range(width):
            valid = j < count
            node = sub_node[torch.where(valid, start + j, 0)]
            row = node_packed[node]
            cur_t, cur_s = bt[ci], bs[ci]
            enter = valid & (box_entry(o, iv, row[:, 0:6], cur_t) < INF)
            lid = row[:, 7].long().clamp(min=0)
            lrow = leaves[lid]                                   # [k, 8, 10]
            tri = lrow[:, :, 9]
            WORK["boxes"] += int(valid.sum())
            WORK["triangles"] += int(((tri >= 0) & enter[:, None]).sum())
            hit, t, u, v = _mt(oc, dc, lrow[:, :, 0:3].unbind(-1),
                               lrow[:, :, 3:6].unbind(-1),
                               lrow[:, :, 6:9].unbind(-1))
            ok = hit & (tri >= 0) & enter[:, None]
            t = torch.where(ok, t, INF)
            t_best = t.amin(1)
            k = torch.where((t == t_best[:, None]) & ok, kk,
                            SUB_SLOTS).amin(1).clamp(max=SUB_SLOTS - 1)
            slot = lid * SUB_SLOTS + k
            better = ok.any(1) & ((t_best < cur_t) | (
                (t_best == cur_t) & (slot < cur_s)))
            sel = k[:, None]
            bt[ci] = torch.where(better, t_best, cur_t)
            bs[ci] = torch.where(better, slot, cur_s)
            bi[ci] = torch.where(better, tri.gather(1, sel)[:, 0].int(),
                                 bi[ci])
            bu[ci] = torch.where(better, u.gather(1, sel)[:, 0], bu[ci])
            bv[ci] = torch.where(better, v.gather(1, sel)[:, 0], bv[ci])

    walk_top_tree(origin, direction, tables, bt, bs, act, any_hit, visit)
    hit = bs >= 0
    return (torch.where(hit, bi, -1), torch.where(hit, bt, INF),
            torch.where(hit, bu, 0.0), torch.where(hit, bv, 0.0))


stream_plain.calls = 0


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_KERNEL_TABLES = (("nodebox", torch.float32, (12,)),
                  ("childs", torch.int32, (2,)),
                  ("fat_start", torch.int32, ()),
                  ("sub_node", torch.int32, ()))
_BVH_TABLES = (("node_packed", torch.float32, (8,)),
               ("leaf_packed", torch.float32, (SUB_SLOTS * 10,)))


def intersect_stream(origin, direction, scene, active=None, t_max=None,
                     any_hit=False):
    """Closest hit (or, with ``any_hit``, a hit under ``t_max``) of the
    scene's BVH triangles through its ``stream`` tables and its gather-walk
    rows ``bvh``; the sensor plane is not in the tree.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise if the scene has no ``stream`` tables or the kernel cannot
    launch).
    """
    if "stream" not in scene:
        raise ValueError("scene has no stream tables: build it with "
                         "CLIVE2_STREAM_IMPL=1 or traversal='stream'")
    tables, bvh = scene["stream"], scene["bvh"]
    if origin.device.type == "cpu":
        return stream_plain(origin, direction, tables, bvh, active=active,
                            t_max=t_max, any_hit=any_hit)
    from .. import kernels

    kernels.check_tables(tables, _KERNEL_TABLES, "stream")
    kernels.check_tables(bvh, _BVH_TABLES, "bvh")
    rays = kernels.ray_args(origin, direction, active, t_max)
    args = ([kernels.on_device(tables[k].contiguous(), origin.device, k)
             for k, _, _ in _KERNEL_TABLES]
            + [kernels.on_device(bvh[k].contiguous(), origin.device, k)
               for k, _, _ in _BVH_TABLES])
    out = kernels.hit_outputs(origin)
    if rays.n:
        kernels.call("clive2_stream", origin.device, *rays.pointers(),
                     *map(kernels.ptr, args), ctypes.c_int(int(any_hit)),
                     *map(kernels.ptr, out))
        intersect_stream.launches += 1
    return out


intersect_stream.launches = 0
