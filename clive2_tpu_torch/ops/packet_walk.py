"""The packet walk of the JAX package's two traversal tools: the CUDA kernel
in csrc/packet_walk.cu, its wrapper and its plain PyTorch version.

Replaces the TPU kernels ``scripts/kernel_stats.py:_count_kernel`` (the
counting walk) and ``scripts/kernel_microbench.py:make_kernel`` (the same
walk, closest hit, in five ablated variants).  Their function is not the
per-ray traversal of ops/traverse_bvh2.py: every ray of a packet shares one
stack, the walk counts its work per packet, and it returns each ray's best
t and triangle id.  It reads the BVH2 kernel's own tables
(``traverse_bvh2.pack_bvh2``: ``nodes`` [I, 16], ``tris`` [R, 12]), whose
inner nodes are numbered as the scripts' ``childs`` with A the left child.

Per packet the stack starts as [root].  Each pop counts one node pop and
tests both children's boxes for every ray with the scripts' slab test,
culled at the ray's best t itself (not ``intersect.cull_bound``: the packet
fixes the visit order, so the answer does not depend on a schedule, and it
equals the TPU kernels' answer).  A child some ray hits is pushed if inner
and tested at once if a leaf, A before B; each leaf test counts one leaf
visit.  A leaf test runs the leaf's triangles against each group of
``group`` rays where some ray of the group hit the leaf box (or every group,
``nogroupskip``), each group tested counting one activation.  A hit needs
the ray's own box hit and t in (DELTA, best t); within a leaf the least t
wins and, among hits at exactly that t, the largest triangle id.

``VARIANTS`` (the scripts' names) set the leaf phase and the push order:

* ``full``: the packet's least entry distance on each side decides "hit"
  and puts the nearer child on top (A wins an equal comparison);
* ``noleaf``: no leaf is tested (t = t_max, id -1 on every ray);
* ``nogroupskip``: every group of a visited leaf is tested;
* ``noorder``: B pushed, then A (A pops first);
* ``noreduce``: "hit" is an any over the packet, B pushed, then A: the
  walk of ``kernel_stats.py``, the counting variant (``COUNTING``).

Packets: ``packet`` rays, padded at the end with inactive rays (origin 0,
direction (1, 0, 0), t_max 0) as the scripts pad.  The TPU's packet is
1,024 rays in groups of 128; this card's lockstep unit is one warp, 32 rays
in one group.  The kernel takes those two (``SIZES``); the plain version
any packet a multiple of its group.
"""

from __future__ import annotations

import torch

from .intersect import WORK, _mt, safe_inverse
from .traverse_bvh2 import LEAF_BITS, LEAF_SLOTS

INF = float("inf")

# name: (leaf phase, push order), as scripts/kernel_microbench.py:VARIANTS
VARIANTS = {
    "full": ("skip", "tmin"),
    "noleaf": ("none", "tmin"),
    "nogroupskip": ("always", "tmin"),
    "noorder": ("skip", "fixed"),
    "noreduce": ("skip", "any"),
}
COUNTING = "noreduce"           # scripts/kernel_stats.py:_count_kernel's walk
SIZES = ((1024, 128), (32, 32))  # (packet, group): the TPU's and a warp
# Stack entries per packet (csrc/packet_walk.cu:kStack).  Below the node a
# packet pops lie at most one entry per level above it (its ancestors'
# other children), then its two children, so depth + 1 entries suffice
# under pack_bvh2's bound of 64 levels.
STACK = 128
# steps of the plain version between its checks for a packet still
# walking (a finished packet's steps change nothing)
CHECK_EVERY = 8


def packet_count(n: int, packet: int) -> int:
    return -(-n // packet)


def pad_packets(origin, direction, active=None, t_max=None, packet=1024):
    """The rays padded to whole packets as the scripts pad: (origin,
    direction [N', 3], active bool [N'], t_max [N']), N' a multiple of
    ``packet``; padding rays are inactive, at the origin, along +x, with
    t_max 0.  A missing ``active`` is all true, a missing ``t_max``
    inf."""
    n, dev = origin.shape[0], origin.device
    n_pad = packet_count(n, packet) * packet
    o = torch.zeros(n_pad, 3, device=dev)
    d = torch.zeros(n_pad, 3, device=dev)
    d[:, 0] = 1.0
    act = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    tm = torch.zeros(n_pad, device=dev)
    o[:n], d[:n] = origin, direction
    act[:n] = True if active is None else active.bool()
    tm[:n] = INF if t_max is None else t_max.to(torch.float32)
    return o, d, act, tm


def _slab(lo, hi, o, inv, bt, act):
    """The scripts' slab test (kernel_stats.py:47-62) of both children's
    boxes (lo, hi [R, 2, 3]) for every ray of each packet (o, inv [R, P, 3],
    bt [R, P], act [R, P]): (hit [R, 2, P], entry distance where hit else
    inf)."""
    t0 = (lo[:, :, None, :] - o[:, None]) * inv[:, None]
    t1 = (hi[:, :, None, :] - o[:, None]) * inv[:, None]
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                         torch.clamp(near[..., 2], min=0.0))
    tmax = torch.minimum(torch.minimum(far[..., 0], far[..., 1]),
                         torch.minimum(far[..., 2], bt[:, None]))
    hit = (tmin <= tmax) & act[:, None]
    return hit, torch.where(hit, tmin, INF)


def _leaf_step(t, geo, ok_box, ids, bt, bi):
    """One leaf's update of (bt, bi) from its Möller-Trumbore results t,
    geo [R, P, 8] (ok_box: the ray's box hit and the slot's validity): the
    least t under bt wins, the largest id among hits at exactly that t."""
    ok = geo & (t < bt[..., None]) & ok_box
    t = torch.where(ok, t, INF)
    tmin = t.amin(2)
    best = torch.where(ok & (t == tmin[..., None]), ids, -1).amax(2)
    found = tmin < bt
    return torch.where(found, tmin, bt), torch.where(found, best, bi)


def packet_walk_plain(origin, direction, tables, active=None, t_max=None, *,
                      packet=1024, group=128, variant="full", count=False):
    """Plain PyTorch version of the kernel: every packet walks in lockstep
    with the others, one node pop per step (a packet whose stack is empty
    idles).  Returns (t [N] f32, id [N] i32) and, with ``count``, the
    per-packet (node pops, leaf visits, activations) [packets, 3] i32.
    Adds the slab tests (two per ray per pop) and Möller-Trumbore tests (a
    leaf's triangles per ray of each group tested) to ``intersect.WORK``."""
    packet_walk_plain.calls += 1
    leaf_mode, order_mode = VARIANTS[variant]
    if packet % group:
        raise ValueError(f"packet {packet} is not a multiple of group "
                         f"{group}")
    n, dev = origin.shape[0], origin.device
    if not n:
        out = (torch.empty(0, device=dev),
               torch.empty(0, dtype=torch.int32, device=dev))
        return (*out, torch.empty(0, 3, dtype=torch.int32, device=dev)
                ) if count else out
    o, d, act, bt = pad_packets(origin, direction, active, t_max, packet)
    r = o.shape[0] // packet
    inv = safe_inverse(d).view(r, packet, 3)
    o, d = o.view(r, packet, 3), d.view(r, packet, 3)
    oc = tuple(c[..., None] for c in o.unbind(-1))       # [R, P, 1] each
    dc = tuple(c[..., None] for c in d.unbind(-1))
    act = act.view(r, packet)
    bt = bt.view(r, packet).clone()
    bi = torch.full((r, packet), -1, dtype=torch.int32, device=dev)

    nodes = tables["nodes"]
    lo = nodes[:, [0, 2, 8, 4, 6, 10]].view(-1, 2, 3)      # A, B
    hi = nodes[:, [1, 3, 9, 5, 7, 11]].view(-1, 2, 3)
    refs = nodes[:, 12:14].contiguous().view(torch.int32).long()
    tris = tables["tris"]
    slots = torch.arange(LEAF_SLOTS, device=dev)
    stack = torch.zeros(r, STACK, dtype=torch.int64, device=dev)
    sp = torch.ones(r, dtype=torch.int64, device=dev)
    stats = torch.zeros(r, 3, dtype=torch.int64, device=dev)
    work = torch.zeros(2, dtype=torch.int64, device=dev)  # boxes, triangles

    def step():
        """One lockstep step of every packet, in place."""
        alive = sp > 0
        sp.sub_(alive.long())
        node = stack.gather(1, sp[:, None])[:, 0]
        stats[:, 0] += alive
        work[0] += 2 * packet * alive.sum()
        hit, near = _slab(lo[node], hi[node], o, inv, bt,
                          act & alive[:, None])
        nearest = near.amin(2)                                # [R, 2]
        any_ab = hit.any(2) if order_mode == "any" else nearest < INF
        near_a, near_b = nearest.unbind(1)
        a_top = (near_a <= near_b if order_mode == "tmin"
                 else torch.ones_like(alive))
        ca, cb = refs[node].unbind(1)
        any_a, any_b = any_ab.unbind(1)
        push_a, push_b = any_a & (ca >= 0), any_b & (cb >= 0)
        both = push_a & push_b
        # both pushed: the top one pops first; one pushed: that one
        lower = torch.where(both, torch.where(a_top, cb, ca),
                            torch.where(push_a, ca, cb))
        for at, value, put in ((sp, lower, push_a | push_b),
                               (sp + 1, torch.where(a_top, ca, cb), both)):
            at = at.clamp(max=STACK - 1)[:, None]
            stack.scatter_(1, at, torch.where(put[:, None], value[:, None],
                                              stack.gather(1, at)))
        sp.add_(push_a.long() + push_b.long())
        if leaf_mode == "none":
            return
        # both leaf children's rows at once: [R, 2 * 8, 12]
        go = torch.stack([any_a & (ca < 0), any_b & (cb < 0)], 1)
        code = ~torch.stack([ca, cb], 1)
        first, cnt = code >> LEAF_BITS, code & ((1 << LEAF_BITS) - 1)
        valid = go[..., None] & (slots < cnt[..., None])       # [R, 2, 8]
        rows = tris[torch.where(valid, first[..., None] + slots, 0)]
        rows = rows.view(r, 2 * LEAF_SLOTS, 12)
        geo, t, _, _ = _mt(oc, dc, rows[:, None, :, 0:3].unbind(-1),
                           rows[:, None, :, 4:7].unbind(-1),
                           rows[:, None, :, 8:11].unbind(-1))
        ids = rows[:, None, :, 3].to(torch.int32).expand_as(t)
        gate = hit.view(r, 2, packet // group, group).any(3)
        tested = (gate.sum(2) if leaf_mode == "skip"
                  else torch.full_like(cnt, packet // group)) * go
        stats[:, 1] += go.sum(1)
        stats[:, 2] += tested.sum(1)
        work[1] += (tested * cnt).sum() * group
        best = bt, bi
        for k, side in enumerate((slice(0, 8), slice(8, 16))):
            ok_box = hit[:, k, :, None] & valid[:, None, k]
            best = _leaf_step(t[..., side], geo[..., side], ok_box,
                              ids[..., side], *best)
        bt.copy_(best[0])
        bi.copy_(best[1])

    # A step is some 150 small operations, so on the card their launches
    # would set its time: there the first step runs as it is and the rest
    # replay it as one CUDA graph.
    run, steps = step, 0
    if dev.type == "cuda":
        step()
        steps = 1
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        run = graph.replay
    while steps % CHECK_EVERY or bool((sp > 0).any()):
        run()
        steps += 1
    WORK["boxes"] += int(work[0])
    WORK["triangles"] += int(work[1])
    out = (bt.view(-1)[:n], bi.view(-1)[:n])
    return (*out, stats.to(torch.int32)) if count else out


packet_walk_plain.calls = 0


# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_TABLES = (("nodes", torch.float32, (16,)), ("tris", torch.float32, (12,)))


def packet_walk(origin, direction, tables, active=None, t_max=None, *,
                packet=1024, group=128, variant="full", count=False):
    """The packet walk of ``tables`` (the ``bvh2`` tables of a scene):
    (t [N], id [N] i32) and, with ``count``, the per-packet counts
    [packets, 3] i32 (node pops, leaf visits, activations).  The rays are
    walked in the order given, ``packet`` at a time.

    CPU tensors take the plain version (``packet_walk_plain``); CUDA
    tensors launch the kernel, which takes the ``SIZES`` packets, and
    raise if it cannot launch."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: expected one of "
                         f"{', '.join(VARIANTS)}")
    if origin.device.type == "cpu":
        return packet_walk_plain(origin, direction, tables, active, t_max,
                                 packet=packet, group=group, variant=variant,
                                 count=count)
    from .. import kernels

    if (packet, group) not in SIZES:
        raise ValueError(f"the kernel takes (packet, group) in {SIZES}, got "
                         f"({packet}, {group})")
    kernels.check_tables(tables, _TABLES, "packet walk")
    rays = kernels.ray_args(origin, direction, active, t_max)
    nodes, tris = kernels.aligned_tables(tables, _TABLES, origin.device,
                                         "packet walk")
    n, dev = rays.n, origin.device
    t = torch.empty(n, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(packet_count(n, packet), 3, dtype=torch.int32,
                        device=dev)
    if n:
        kernels.call("clive2_packet_walk", dev, *rays.pointers(),
                     kernels.ptr(nodes), kernels.ptr(tris),
                     packet, list(VARIANTS).index(variant), int(count),
                     kernels.ptr(t),
                     kernels.ptr(ids), kernels.ptr(stats))
        packet_walk.launches += 1
    return (t, ids, stats) if count else (t, ids)


packet_walk.launches = 0
