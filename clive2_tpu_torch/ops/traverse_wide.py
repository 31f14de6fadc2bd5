"""BVH8 (wide) traversal: the CUDA kernel in csrc/traverse_wide.cu, its
collapse and packer, and its plain PyTorch version (``wide_plain``).

Replaces the TPU kernel ``clive2_tpu/ops/traverse_wide.py:_kernel``.  The
binary SAH tree is collapsed into 8-wide nodes (``collapse_bvh8``: the
inner candidate with the largest surface area is expanded until a node has
8 children; wide nodes are numbered in DFS preorder).  A ray pops a wide
node, slab-tests its child boxes against its best t, pushes the hit inner
children with their entry distances, the nearest last so that it is popped
first, and tests the triangles of each hit leaf child.  A popped entry is
skipped when its entry distance exceeds the best t.  The winner is the
lexicographic minimum of (t, row), a row being the triangle's place in the
compact triangle rows (``traverse_bvh2.triangle_rows``), which list the
gather walk's real slots in slot order, so no visit order decides a tie.

Tables (``pack_bvh8``), read by the kernel with 16-byte loads:

* ``nodes`` [W, 64] f32: one 256-byte record per wide node (node 0 is the
  root), child-major, 8 floats per child: lo(3), its reference as int32
  bits, hi(3), 0.  A reference >= 0 is an inner wide node, a leaf is
  ``~(first << LEAF_BITS | count)`` (``traverse_bvh2.leaf_spans``), and
  ``EMPTY`` an empty child, with the box min = max = +BIG, after the
  others;
* ``tris`` [R, 12] f32: the compact triangle rows; no padding slot is read.

Departures from the TPU kernel, each for a TPU limit the card does not have:

* the [56, 128] lane tile of child boxes with its inner-flag rows: a wide
  node is one child-major record;
* slot-aligned leaf pages (bin packing, children reordered to page slots,
  ``lblocks``) and the compact 12-slot layout: a leaf child names a range
  of triangle rows;
* the ``group_gate``, ``pop2`` and ``bits`` variants, ``MAX_BLOCKS_PER_CALL``
  launch splitting and the Morton sort of the rays: persistent warps, one
  lane per ray;
* the tie rule: the TPU kernel takes the largest triangle id among equal t
  within a leaf tile and the first tile visited across tiles.

Kept: the collapse, the empty-child box sentinel min = max = +BIG (an
inverted box would become an always-hit under the min/max slab test; empty
children are also skipped by their reference), and the pack-time stack
bound, computed for this kernel's stack.  Any-hit stops after the first
wide node whose leaf children leave a hit under the cap.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .intersect import INF, WORK, _mt, box_entry, pop_stack, safe_inverse
from .traverse_bvh2 import LEAF_BITS, LEAF_SLOTS, leaf_spans, triangle_rows
from .traverse_stream import PLAIN_CHUNK

WIDE = 8            # children per wide node
CHILD = 8           # floats per child in a node record: lo(3) ref hi(3) 0
STACK_SIZE = 96     # csrc/traverse_wide.cu:kWideStack
BIG = 1e30          # empty-child box: min = max = +BIG
EMPTY = -(1 << 31)  # an empty child's reference (csrc/common.cuh:kNone)
MAX_NODES = 1 << 24     # the kernel keeps a node id in 24 bits beside a mask


def collapse_bvh8(node_packed):
    """Collapse the binary tree of the gather walk's node rows into 8-wide
    nodes, as ``clive2_tpu.ops.traverse_wide.collapse_bvh8`` does on the
    FlatBVH: start from a root's two children, expand the inner child with
    the largest surface area (the first of equal ones) until 8 children or
    none is inner; inner children become wide nodes, numbered in DFS
    preorder.  Inner node b's children are b + 1 and miss[b + 1].

    Returns (wide_children: per wide node its child list of binary node
    ids, wide_of: binary node -> wide id).
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    miss = node_packed[:, 6].astype(np.int64)
    is_leaf = node_packed[:, 7] >= 0
    if is_leaf[0]:
        raise ValueError("BVH8 collapse requires an inner root")
    ext = node_packed[:, 3:6] - node_packed[:, 0:3]
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 0] * ext[:, 2])
    right = np.zeros(len(miss), dtype=np.int64)
    inner = np.nonzero(~is_leaf)[0]
    right[inner] = miss[inner + 1]
    leaf_l, area_l, right_l = is_leaf.tolist(), area.tolist(), right.tolist()

    wide_children = []
    wide_of = {}
    todo = [0]                       # binary roots of wide nodes, DFS
    while todo:
        root = todo.pop()
        wide_of[root] = len(wide_children)
        slots = [root + 1, right_l[root]]
        while len(slots) < WIDE:
            cand, cand_a = -1, -1.0
            for k, b in enumerate(slots):
                if not leaf_l[b] and area_l[b] > cand_a:
                    cand, cand_a = k, area_l[b]
            if cand < 0:
                break
            b = slots.pop(cand)
            slots.extend((b + 1, right_l[b]))
        wide_children.append(slots)
        for b in reversed(slots):    # reversed: pops come in preorder
            if not leaf_l[b]:
                todo.append(b)
    return wide_children, wide_of


def stack_bound(refs):
    """The most stack entries a ray can hold, from the child references
    ``refs`` [W, 8] (>= 0 inner): visiting wide node w pushes its hit inner
    children, and each ancestor a on the way leaves at most inner(a) - 1
    entries (its other children) below them."""
    n_inner = (refs >= 0).sum(axis=1)
    below = np.zeros(len(refs), dtype=np.int64)
    for w in range(len(refs)):       # preorder: parents come first
        kids = refs[w][refs[w] >= 0]
        below[kids] = below[w] + n_inner[w] - 1
    return int((below + n_inner).max(initial=0))


def node_records(boxes, refs):
    """[W, 64] f32 wide-node records from each child's box [W, 8, 6]
    (min(3) max(3)) and reference [W, 8] int32: child-major, lo(3), the
    reference as int32 bits, hi(3), 0."""
    rec = np.zeros((len(boxes), WIDE, CHILD), dtype=np.float32)
    rec[:, :, 0:3] = boxes[:, :, 0:3]
    rec.view(np.int32)[:, :, 3] = refs
    rec[:, :, 4:7] = boxes[:, :, 3:6]
    return rec.reshape(len(boxes), WIDE * CHILD)


def decode_records(nodes):
    """The inverse of ``node_records`` on a tensor: (boxes [W, 8, 6],
    references [W, 8] int64)."""
    rec = nodes.reshape(-1, WIDE, CHILD)
    refs = nodes.view(torch.int32).reshape(-1, WIDE, CHILD)[..., 3]
    return rec[..., [0, 1, 2, 4, 5, 6]], refs.long()


def pack_bvh8(node_packed, leaf_packed):
    """Kernel tables from the gather walk's packed rows: dict(nodes [W, 64],
    tris [R, 12], both f32; see the module note).

    Raises when the root is a leaf, a ray could need more stack than the
    kernel has, a triangle id does not fit an f32 row (2^24), or there are
    more wide nodes than the kernel's 24-bit node ids hold.
    """
    node_packed = np.asarray(node_packed, dtype=np.float32)
    tris = triangle_rows(leaf_packed)
    first, count = leaf_spans(leaf_packed)
    wide_children, wide_of = collapse_bvh8(node_packed)
    n_wide = len(wide_children)
    if n_wide > MAX_NODES:
        raise ValueError(f"{n_wide} wide nodes: the kernel holds node ids "
                         f"below {MAX_NODES}")
    counts = [len(s) for s in wide_children]
    flat = np.fromiter(itertools.chain.from_iterable(wide_children),
                       dtype=np.int64, count=sum(counts))
    w_idx = np.repeat(np.arange(n_wide), counts)
    c_idx = np.concatenate([np.arange(c) for c in counts])

    wide_id = np.full(node_packed.shape[0], -1, dtype=np.int64)
    wide_id[list(wide_of)] = list(wide_of.values())
    leaf_id = node_packed[flat, 7].astype(np.int64)
    leaf = np.maximum(leaf_id, 0)
    boxes = np.full((n_wide, WIDE, 6), BIG, dtype=np.float32)
    boxes[w_idx, c_idx] = node_packed[flat, 0:6]
    refs = np.full((n_wide, WIDE), EMPTY, dtype=np.int64)
    refs[w_idx, c_idx] = np.where(
        leaf_id >= 0, ~((first[leaf] << LEAF_BITS) | count[leaf]),
        wide_id[flat])
    need = stack_bound(refs)
    if need > STACK_SIZE:
        raise ValueError(f"BVH8 traversal may need {need} stack entries, "
                         f"past the wide kernel's {STACK_SIZE}")
    return dict(nodes=node_records(boxes, refs.astype(np.int32)), tris=tris)


def wide_plain(origin, direction, tables, active=None, t_max=None,
               any_hit=False):
    """Plain PyTorch version of the kernel on its own ``tables``
    (``pack_bvh8``): the same stack machine (every child box against the
    best t at the visit, hit inner children pushed in child order with the
    nearest last, then the hit leaf children's rows in ``_mt``'s order), the
    same (t, row) rule and any-hit stop.  Rays advance in lockstep, one
    wide node per step."""
    wide_plain.calls += 1
    dev = origin.device
    n = origin.shape[0]
    boxes, refs = decode_records(tables["nodes"])
    tris = tables["tris"]
    cc = torch.arange(WIDE, device=dev)
    kk = torch.arange(LEAF_SLOTS, device=dev)

    act = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
           else active.bool())
    bt = (torch.full((n,), INF, device=dev) if t_max is None
          else t_max.to(torch.float32).clone())
    bs = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    inv = safe_inverse(direction)
    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack_ref = torch.zeros(n, STACK_SIZE, dtype=torch.int32, device=dev)
    stack_t = torch.zeros(n, STACK_SIZE, device=dev)

    def visit(ci):
        r = ref[ci]
        ch = refs[r]                                          # [m, 8]
        o, iv = origin[ci], inv[ci]
        tc = box_entry(o[:, None, :], iv[:, None, :], boxes[r],
                       bt[ci, None])
        tc = torch.where(ch == EMPTY, INF, tc)
        WORK["boxes"] += int((ch != EMPTY).sum())
        hitc = tc < INF
        inner = hitc & (ch >= 0)
        best = torch.where(inner, tc, INF).argmin(1)          # first minimum
        has_best = inner.any(1)
        push = inner & ((cc != best[:, None]) | ~has_best[:, None])
        rr, c = torch.nonzero(push, as_tuple=True)
        pos = sp[ci][rr] + push.cumsum(1)[rr, c] - 1
        stack_ref[ci[rr], pos] = ch[rr, c].int()
        stack_t[ci[rr], pos] = tc[rr, c]
        top = sp[ci] + push.sum(1)
        hb = torch.nonzero(has_best).squeeze(1)
        stack_ref[ci[hb], top[hb]] = ch[hb, best[hb]].int()
        stack_t[ci[hb], top[hb]] = tc[hb, best[hb]]
        sp[ci] = top + has_best

        leafc = hitc & (ch < 0)
        lr = torch.nonzero(leafc.any(1)).squeeze(1)
        if not lr.numel():
            return
        li = ci[lr]
        code = torch.where(leafc[lr], ~ch[lr], 0)             # [k, 8]
        count = code & ((1 << LEAF_BITS) - 1)
        real = kk < count[:, :, None]                         # [k, 8, 8]
        row = torch.where(real, (code >> LEAF_BITS)[:, :, None] + kk, 0)
        tr = tris[row]                                        # [k, 8, 8, 12]
        oc = tuple(x[:, None, None] for x in origin[li].unbind(-1))
        dc = tuple(x[:, None, None] for x in direction[li].unbind(-1))
        hit, t, u, v = _mt(oc, dc, tr[..., 0:3].unbind(-1),
                           tr[..., 4:7].unbind(-1),
                           tr[..., 8:11].unbind(-1))
        WORK["triangles"] += int(real.sum())
        ok = (hit & real).flatten(1)
        row = row.flatten(1)
        t = torch.where(ok, t.flatten(1), INF)
        t_best = t.amin(1)
        first = (t == t_best[:, None]) & ok
        s_best = torch.where(first, row, tris.shape[0]).amin(1)
        sel = (first & (row == s_best[:, None])).int().argmax(1, True)
        cur_t, cur_s = bt[li], bs[li]
        better = ok.any(1) & ((t_best < cur_t) | (
            (t_best == cur_t) & (s_best < cur_s)))
        bt[li] = torch.where(better, t_best, cur_t)
        bs[li] = torch.where(better, s_best, cur_s)
        bi[li] = torch.where(
            better, tr[..., 3].flatten(1).gather(1, sel)[:, 0].int(), bi[li])
        bu[li] = torch.where(better, u.flatten(1).gather(1, sel)[:, 0],
                             bu[li])
        bv[li] = torch.where(better, v.flatten(1).gather(1, sel)[:, 0],
                             bv[li])

    live = torch.nonzero(act).squeeze(1)
    while live.numel():
        for k in range(0, live.numel(), PLAIN_CHUNK):
            visit(live[k:k + PLAIN_CHUNK])
        done = (bs[live] >= 0) & any_hit
        pi = live[~done]
        if pi.numel():
            done[~done] = ~pop_stack(pi, ref, sp, stack_ref, stack_t, bt)
        live = live[~done]

    hit = bs >= 0
    return (torch.where(hit, bi, -1), torch.where(hit, bt, INF),
            torch.where(hit, bu, 0.0), torch.where(hit, bv, 0.0))


wide_plain.calls = 0


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_TABLES = (("nodes", torch.float32, (WIDE * CHILD,)),
           ("tris", torch.float32, (12,)))


def intersect_wide(origin, direction, scene, active=None, t_max=None,
                   any_hit=False):
    """Closest hit (or, with ``any_hit``, a hit under ``t_max``) of the
    scene's BVH triangles through its ``wide`` tables; the sensor plane is
    not in the tree.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise if the scene has no ``wide`` tables or the kernel cannot launch).
    """
    if "wide" not in scene:
        raise ValueError("scene has no wide tables: build it with "
                         "CLIVE2_TRAVERSAL=wide or traversal='wide'")
    tables = scene["wide"]
    if origin.device.type == "cpu":
        return wide_plain(origin, direction, tables, active=active,
                          t_max=t_max, any_hit=any_hit)
    from .. import kernels

    kernels.check_tables(tables, _TABLES, "wide")
    rays = kernels.ray_args(origin, direction, active, t_max)
    # a node record spans exactly two 128-byte lines
    args = kernels.aligned_tables(tables, _TABLES, origin.device, "wide",
                                  align=dict(nodes=256))
    out = kernels.hit_outputs(origin)
    if rays.n:
        # the persistent warps' ray counter, zeroed by clive2_wide on the
        # launch's stream
        counter = torch.empty(1, dtype=torch.int64, device=origin.device)
        kernels.call("clive2_wide", origin.device, *rays.pointers(),
                     *map(kernels.ptr, args), kernels.ptr(counter),
                     int(any_hit), *map(kernels.ptr, out))
        intersect_wide.launches += 1
    return out


intersect_wide.launches = 0


def kernel_info(any_hit=False):
    """What the CUDA runtime reports of the kernel: registers per thread,
    static shared bytes per block, local bytes per thread, resident blocks
    per SM, SMs."""
    from .. import kernels

    return kernels.resources("clive2_wide_info", any_hit)
