"""Fat-leaf traversal for large scenes: the queued CUDA traversal in
csrc/stream2_queue.cu and csrc/traverse_stream2.cu, its packer, and the
plain PyTorch versions (``stream2_plain`` for the whole cast, and one per
kernel of the queued traversal).

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
* rays are queued per fat leaf (``queued_cast``) in place of the TPU's
  4096-ray packets, DMA ring and chunk masks: a cast runs in chunks of at
  most ``CHUNK`` rays, each in rounds of (a) a walk of every live ray to
  its next fat leaf, resumed from a stack kept in device memory, (b) a
  counting sort of the rays by fat leaf into tiles of ``TILE`` rays, (c) one
  block per tile that loads the fat leaf's feature rows into shared memory
  once and runs the exact FP32 test of every slot against its rays (a
  second instance first rejects the (ray, slot) pairs that a TF32
  tensor-core product shows to clearly miss, the MXU matmul's place;
  ``tf32_filter_plain``).  Once fewer than ``TAIL_MIN`` rays are live, the
  per-thread kernel finishes them from their saved state, on a side stream
  so that it overlaps the next chunk; a cast of fewer than ``QUEUE_MIN``
  rays takes that kernel whole.  The SMEM-budget loop over
  ``blocks_per_leaf`` is gone (the parameter stays for tests).

Kept: the cut, the child encoding (>= 0 top node, ``-(f + 1)`` fat leaf f),
the centre shift (it conditions the bilinear forms), inactive rays and
caps: an INF cap is clamped to 1e30 as the TPU wrapper does, and any-hit
stops after the first fat leaf that holds a hit under the cap.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from ..constants import DELTA
from .intersect import INF, WORK, _mt, box_entry, cull_bound, safe_inverse
# the cut, the top tree and its walk are the stream1 kernel's
# (ops/traverse_stream.py), as in the JAX package, where stream2 imports
# ``_cut_mask`` from traverse_stream
from .traverse_stream import _cut_mask  # noqa: F401
from .traverse_stream import (PLAIN_CHUNK, check_leaf_rows, top_tree,
                              walk_top_tree)

STACK_SIZE = 64     # csrc/traverse_stream2.cu:kStackSize
DONE = -(1 << 31)   # the ref of a retired ray (csrc/stream2.cuh:kDone)
TILE = 128          # rays per leaf-test block (csrc/stream2_queue.cu:kTile)
CHUNK = 1 << 22     # rays per chunk of the queued traversal
# live rays below which the per-thread kernel finishes a chunk: of 0, 2^12,
# 2^14, 2^16 and 2^18, 2^16 was fastest on the medium dragon's and sponza
# 1080p's casts (PERF.md)
TAIL_MIN = 1 << 16
# casts of fewer rays take the per-thread kernel whole: it was faster on the
# medium dragon 512's extension casts (524,288 rays), the queued traversal
# on sponza 1080p's (4,147,200), and a queued cast reads counts from the
# card (PERF.md)
QUEUE_MIN = 1 << 20
# the leaf-test instance the wrapper launches: the FP32-only one measured
# faster on sponza 1080p's connection cast (PERF.md)
LEAF_TEST = "fp32"
FILTER_EPS = 2.0 ** -8      # the prefilter's margin (csrc/stream2_queue.cu)
FILTER_FLOOR = 2.0 ** -96
FILTER_HUGE = 2.0 ** 50
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
    holds slots fat_start[f]:fat_start[f + 1]), depth [1] i32 (the most
    stack entries a top-tree walk pushes), slot_tri [S] i32 global
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
                depth=np.array([tree["depth"]], dtype=np.int32),
                slot_tri=slots[:, 9].astype(np.int32),
                slot_mt=np.ascontiguousarray(slots[:, 0:9]), ctr=ctr)


def slot_pass(tables, f, d, m, osh, width):
    """The exact test of every slot of fat leaf ``f`` [k] for rays with
    features d/m/osh (tuples of [k] tensors): returns (pass [k, width], t
    [k, width], first slot [k]).  The sums run in the kernels' order
    (csrc/stream2.cuh:slot_test)."""
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
    WORK["slots"] += int(valid.sum())
    return ok, t, start


def _leaf_best(tables, f, d, m, osh, width):
    """Best passing slot of fat leaf ``f`` [k] for rays with features
    d/m/osh (tuples of [k] tensors): returns (t, slot), t = inf and slot
    -1 where no slot passes."""
    ok, t, start = slot_pass(tables, f, d, m, osh, width)
    t = torch.where(ok, t, INF)
    t_best = t.amin(1)
    col = torch.arange(width, device=f.device)
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

    walk_top_tree(origin, direction, tables["nodebox"], tables["childs"], bt,
                  bc, act, any_hit, visit)
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


# ---- the queued traversal: state, schedule and plain steps -------------------

@dataclasses.dataclass
class QueueState:
    """One chunk's per-ray state between the queued traversal's launches
    (layout: csrc/stream2.cuh): ``ray`` [n, 16] (origin, direction, inverse
    direction, moment, shifted origin), ``bt``/``bc`` the best t and slot,
    ``ref``/``sp`` and the ``[depth, n]`` stack of the top-tree walk,
    ``leaf`` the fat leaf each ray waits at (-1 none), and the binning's
    ``hist``/``offs``/``cursor`` [F], ``queue`` of tiles (fat leaf f's rays
    at ``offs[f]``, padded to whole tiles) and ``info`` (live rays,
    tiles)."""

    ray: torch.Tensor
    bt: torch.Tensor
    bc: torch.Tensor
    ref: torch.Tensor
    sp: torch.Tensor
    stack_ref: torch.Tensor
    stack_t: torch.Tensor
    leaf: torch.Tensor
    hist: torch.Tensor
    offs: torch.Tensor
    cursor: torch.Tensor
    queue: torch.Tensor
    info: torch.Tensor

    @classmethod
    def empty(cls, n, depth, n_fat, device):
        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device=device)

        return cls(ray=torch.empty(n, 16, device=device),
                   bt=torch.empty(n, device=device), bc=i32(n), ref=i32(n),
                   sp=i32(n), stack_ref=i32(depth, n),
                   stack_t=torch.empty(depth, n, device=device), leaf=i32(n),
                   hist=i32(n_fat), offs=i32(n_fat), cursor=i32(n_fat),
                   queue=i32(n + (TILE - 1) * min(n_fat, n)), info=i32(2))

    @property
    def n(self):
        return self.ray.shape[0]

    @property
    def max_tiles(self):
        """The most tiles a round can fill: each fat leaf pads its rays to
        whole tiles."""
        return -(-self.n // TILE) + min(self.hist.numel(), self.n)

    def clone(self):
        return QueueState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def queued_cast(rays, steps, out, chunk=CHUNK, tail_min=TAIL_MIN):
    """The queued traversal's schedule, for the kernels and their plain
    versions alike: ``steps`` gives ``state(n)``, ``walk(state, rays)``
    (``rays`` only in a chunk's first round), ``bin(state)`` (returns a
    function that reads that round's (live rays, tiles)), ``leaf_test(
    state)``, ``tail(state, out)`` and ``join()`` (after the last tail).
    ``rays`` is (origin, direction, active, t_max), ``out`` the (ids, t, u,
    v) the tails write.

    A chunk runs rounds of leaf test, walk and binning.  Each round's live
    count is read one round late, so the host launches a round while the
    card runs the one before and never waits on a round it just launched:
    the chunk stops after the first round that began with fewer than
    ``tail_min`` live rays (with none, when it is 0), and the tail finishes
    it.  Returns (rounds, rays left to the tail)."""
    n = rays[0].shape[0]
    rounds, lasts = 0, []
    for lo in range(0, n, chunk):
        part = tuple(x[lo:lo + chunk] for x in rays)
        st = steps.state(part[0].shape[0])
        steps.walk(st, part)
        counts = [steps.bin(st)]
        while True:
            steps.leaf_test(st)
            steps.walk(st)
            counts.append(steps.bin(st))
            rounds += 1
            live = counts[-2]()[0]         # the live rays this round began with
            if live == 0 or live < tail_min:
                break
        lasts.append(counts[-1])
        steps.tail(st, tuple(x[lo:lo + chunk] for x in out))
    steps.join()
    return rounds, sum(read()[0] for read in lasts)


def ray_rows(origin, direction, ctr):
    """[n, 16] ray state rows (csrc/stream2.cuh:ray_row)."""
    osh = origin - ctr
    ox, oy, oz = osh.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    m = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                     ox * dy - oy * dx], dim=1)
    return torch.cat([origin, direction, safe_inverse(direction), m, osh,
                      torch.zeros_like(dx)[:, None]], dim=1)


def _pop(st, rays):
    """One lockstep pop of the [depth, n] stack for ``rays``
    (intersect.pop_stack's rule); a ray that finds no entry retires."""
    levels = torch.arange(st.stack_t.shape[0], device=rays.device)
    ok = ((levels < st.sp[rays, None])
          & (st.stack_t[:, rays].T <= cull_bound(st.bt[rays, None])))
    j = (ok * (levels + 1)).amax(1) - 1
    found = j >= 0
    st.ref[rays[found]] = st.stack_ref[j[found], rays[found]]
    st.ref[rays[~found]] = DONE
    st.sp[rays] = j.clamp(min=0).to(torch.int32)


def walk_to_leaf_plain(st, tables, any_hit, rays=None):
    """Plain version of the walk kernel: with ``rays`` (a chunk's first
    round) the state is set from them; otherwise each ray whose fat leaf
    was just tested stops (any-hit with a hit) or pops.  Then every live
    ray walks the top tree in lockstep, as stream2_plain does, to its next
    fat leaf (``st.leaf``) or retires."""
    nodebox, childs = tables["nodebox"], tables["childs"]
    if rays is not None:
        origin, direction, active, t_max = rays
        st.ray.copy_(ray_rows(origin, direction, tables["ctr"]))
        st.bt.copy_(torch.where(t_max < CAP_CLAMP, t_max, CAP_CLAMP))
        st.bc.fill_(-1)
        st.sp.zero_()
        st.ref.copy_(torch.where(active.bool(), 0, DONE))
    else:
        at = torch.nonzero(st.ref != DONE).squeeze(1)
        stop = (st.bc[at] >= 0) & any_hit
        st.ref[at[stop]] = DONE
        _pop(st, at[~stop])
    live = torch.nonzero(st.ref >= 0).squeeze(1)
    while live.numel():
        WORK["boxes"] += 2 * live.numel()
        r = st.ref[live].long()
        o, inv, bt = st.ray[live, 0:3], st.ray[live, 6:9], st.bt[live]
        ta = box_entry(o, inv, nodebox[r, 0:6], bt)
        tb = box_entry(o, inv, nodebox[r, 6:12], bt)
        ca, cb = childs[r, 0], childs[r, 1]
        ha, hb = ta < INF, tb < INF
        both = ha & hb
        a_near = ta <= tb
        pi = live[both]
        psp = st.sp[pi].long()
        st.stack_ref[psp, pi] = torch.where(a_near, cb, ca)[both]
        st.stack_t[psp, pi] = torch.where(a_near, tb, ta)[both]
        st.sp[pi] += 1
        st.ref[live] = torch.where(both, torch.where(a_near, ca, cb),
                                   torch.where(ha, ca, cb))
        _pop(st, live[~(ha | hb)])
        live = live[st.ref[live] >= 0]
    done = st.ref == DONE
    st.leaf.copy_(torch.where(done, -1, -(st.ref.long() + 1)))


def plan_tiles_plain(st):
    """Plain version of the plan kernel: ``st.offs`` = ``st.cursor`` = the
    exclusive sum of the counts ``st.hist`` before each fat leaf, each
    padded to whole tiles; ``st.info`` = (live rays, tiles)."""
    padded = (st.hist + (TILE - 1)) // TILE * TILE
    end = torch.cumsum(padded, 0, dtype=torch.int32)
    st.offs.copy_(end - padded)
    st.cursor.copy_(st.offs)
    st.info.copy_(torch.stack([st.hist.sum(dtype=torch.int32),
                               end[-1] // TILE]))


def queue_positions(st):
    """The queue entries that hold rays: fat leaf f's ``hist[f]`` entries
    from ``offs[f]``, fat leaf after fat leaf.  Returns (positions, the fat
    leaf of each)."""
    hist = st.hist.long()
    f = torch.repeat_interleave(torch.arange(hist.numel(),
                                             device=hist.device), hist)
    first = torch.cumsum(hist, 0) - hist
    pos = st.offs.long()[f] + torch.arange(f.numel(), device=f.device) \
        - first[f]
    return pos, f


def bin_by_leaf_plain(st):
    """Plain version of the binning (the count, plan and scatter kernels):
    the live rays by fat leaf into tiles, ascending ray order within a fat
    leaf (the kernel's order there is arbitrary); padding entries are left
    as they were."""
    rays = torch.nonzero(st.leaf >= 0).squeeze(1)
    st.hist.copy_(torch.bincount(st.leaf[rays].long(),
                                 minlength=st.hist.numel()))
    plan_tiles_plain(st)
    pos, _ = queue_positions(st)
    _, order = torch.sort(st.leaf[rays].long(), stable=True)
    st.queue[pos] = rays[order].to(torch.int32)


def _width(tables):
    fat_start = tables["fat_start"]
    return max(int((fat_start[1:] - fat_start[:-1]).max()), 1)


def leaf_test_plain(st, tables):
    """Plain version of the leaf-test kernel: ``_leaf_best`` of each queued
    ray at its fat leaf, merged into (bt, bc) by the (t, slot) rule."""
    rays = st.queue[queue_positions(st)[0]].long()
    width = _width(tables)
    for k in range(0, rays.numel(), PLAIN_CHUNK):
        ci = rays[k:k + PLAIN_CHUNK]
        f = st.leaf[ci].long()
        row = st.ray[ci]
        t_leaf, slot = _leaf_best(tables, f, row[:, 3:6].unbind(-1),
                                  row[:, 9:12].unbind(-1),
                                  row[:, 12:15].unbind(-1), width)
        cur_t, cur_c = st.bt[ci], st.bc[ci].long()
        better = (slot >= 0) & ((t_leaf < cur_t) | (
            (t_leaf == cur_t) & (slot < cur_c)))
        st.bt[ci] = torch.where(better, t_leaf, cur_t)
        st.bc[ci] = torch.where(better, slot, cur_c).to(torch.int32)



def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def clearly_misses(a, u, v, t, ma, mu, mv, mt, bt):
    """The prefilter's margin rule (csrc/stream2_queue.cu:clearly_misses)
    on the forms a, u_n, v_n, t_n and their magnitude bounds."""
    aa = a.abs()
    sure = (aa > FILTER_EPS * ma + FILTER_FLOOR) & (aa < FILTER_HUGE)
    s = torch.where(a > 0, 1.0, -1.0)
    su, sv, st = s * u, s * v, s * t
    return sure & (
        (su < -(FILTER_EPS * mu + FILTER_FLOOR))
        | (sv < -(FILTER_EPS * mv + FILTER_FLOOR))
        | (aa - su - sv < -(FILTER_EPS * (ma + mu + mv) + FILTER_FLOOR))
        | (st - DELTA * aa < -(FILTER_EPS * (mt + DELTA * ma)
                               + FILTER_FLOOR))
        | (st - bt * aa > FILTER_EPS * (mt + bt * ma) + FILTER_FLOOR))


def tf32_filter_plain(tables, f, row, bt, width):
    """Plain version of the leaf-test kernel's prefilter: for rays with
    state rows ``row`` [k, 16] and best t ``bt`` at fat leaves ``f`` [k],
    the [k, width] mask of the slots that survive (not ``clearly_misses``
    on the TF32 products).  The tensor core sums its 8 exact products in an
    order of its own; here they are summed in k order in f32, so a pair
    within a few 2^-23 of a threshold may come out otherwise."""
    fat_start = tables["fat_start"]
    start = fat_start[f].long()
    col = torch.arange(width, device=f.device)
    valid = col < (fat_start[f + 1].long() - start)[:, None]
    c = _tf32(tables["feat"][torch.where(valid, start[:, None] + col, 0)])
    dm = _tf32(row[:, [3, 4, 5, 9, 10, 11]])[:, None, :]     # [k, 1, 6]
    osh = _tf32(row[:, 12:15])[:, None, :]

    def dot(x, coeff, const=None):
        terms = (x * coeff).unbind(-1)
        if const is not None:
            terms = terms + (const,)
        acc = terms[0]
        for term in terms[1:]:
            acc = acc + term
        return acc

    forms = (c[..., 0:3], c[..., 3:9], c[..., 9:15], c[..., 15:18])
    vals = [dot(dm[..., :3], forms[0]), dot(dm, forms[1]), dot(dm, forms[2]),
            dot(osh, forms[3], c[..., 18])]
    mags = [dot(dm[..., :3].abs(), forms[0].abs()),
            dot(dm.abs(), forms[1].abs()), dot(dm.abs(), forms[2].abs()),
            dot(osh.abs(), forms[3].abs(), c[..., 18].abs())]
    return valid & ~clearly_misses(*vals, *mags, bt[:, None])


def finish_plain(st, tables, out):
    """The outputs of a finished chunk: exact Möller-Trumbore on each
    winner's slot_mt row (the tail kernel's end)."""
    hit = st.bc >= 0
    bc = st.bc.long().clamp(min=0)
    row = tables["slot_mt"][bc]
    _, t, u, v = _mt(st.ray[:, 0:3].unbind(-1), st.ray[:, 3:6].unbind(-1),
                     row[:, 0:3].unbind(-1), row[:, 3:6].unbind(-1),
                     row[:, 6:9].unbind(-1))
    for dst, src in zip(out, (
            torch.where(hit, tables["slot_tri"][bc], -1).to(torch.int32),
            torch.where(hit, t, INF), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0))):
        dst.copy_(src)


# the top tree's depth of each ``depth`` table, read from the card once
_DEPTH = weakref.WeakKeyDictionary()


def _depth(tables):
    t = tables["depth"]
    if t not in _DEPTH:
        _DEPTH[t] = int(t[0])
    return _DEPTH[t]


class PlainSteps:
    """The queued traversal's steps as plain PyTorch (``queued_cast``)."""

    def __init__(self, tables, any_hit):
        self.tables, self.any_hit = tables, any_hit

    def state(self, n):
        t = self.tables
        return QueueState.empty(n, _depth(t), t["fat_start"].numel() - 1,
                                t["fat_start"].device)

    def walk(self, st, rays=None):
        walk_to_leaf_plain(st, self.tables, self.any_hit, rays)

    def bin(self, st):
        bin_by_leaf_plain(st)
        info = tuple(st.info.tolist())
        return lambda: info

    def leaf_test(self, st):
        leaf_test_plain(st, self.tables)

    def tail(self, st, out):
        """The per-thread walk from the saved state, as rounds of the
        plain steps until every ray is done, then the outputs."""
        while self.bin(st)()[0]:
            self.leaf_test(st)
            self.walk(st)
        finish_plain(st, self.tables, out)

    def join(self):
        pass


# ---- the kernels -------------------------------------------------------------

# the kernel's tables in argument order: (name, dtype, shape past dim 0)
_KERNEL_TABLES = (("nodebox", torch.float32, (12,)),
                  ("childs", torch.int32, (2,)),
                  ("feat", torch.float32, (N_FEAT,)),
                  ("fat_start", torch.int32, ()),
                  ("slot_tri", torch.int32, ()),
                  ("slot_mt", torch.float32, (9,)), ("ctr", torch.float32, ()))
_LEAF_ENTRIES = dict(tf32="clive2_s2q_leaf_tf32", fp32="clive2_s2q_leaf_fp32")


def _p(*tensors):
    from ..kernels import ptr
    return [ptr(t) for t in tensors]


def stream2_thread(rays, tables, any_hit, out):
    """The per-thread kernel on a whole cast (``kernels.RayArgs``)."""
    from .. import kernels

    kernels.call("clive2_stream2", rays.origin.device, *rays.pointers(),
                 *_p(*(tables[k] for k, _, _ in _KERNEL_TABLES)),
                 ctypes.c_int(int(any_hit)), *_p(*out))
    stream2_thread.launches += 1


def walk_to_leaf(st, tables, any_hit, rays=None):
    """The walk kernel (walk_to_leaf_plain's contract); ``rays`` is
    (origin, direction, active as uint8 or bool, t_max) in a chunk's first
    round."""
    from .. import kernels

    first = rays is not None
    o, d, act, cap = rays if first else (st.ray,) * 4
    kernels.call("clive2_s2q_walk", st.ray.device, *_p(o, d, act, cap),
                 ctypes.c_int64(st.n), ctypes.c_int(int(first)),
                 *_p(tables["nodebox"], tables["childs"], tables["ctr"],
                     st.ray, st.bt, st.bc, st.ref, st.sp, st.stack_ref,
                     st.stack_t, st.leaf), ctypes.c_int(int(any_hit)))
    walk_to_leaf.launches += 1


def count_by_leaf(st):
    """The count kernel: ``st.hist`` = live rays per fat leaf."""
    from .. import kernels

    st.hist.zero_()
    kernels.call("clive2_s2q_count", st.ray.device, *_p(st.leaf),
                 ctypes.c_int64(st.n), *_p(st.hist))
    count_by_leaf.launches += 1


def scatter_by_leaf(st):
    """The scatter kernel: each live ray into its fat leaf's queue range,
    from ``st.cursor``."""
    from .. import kernels

    kernels.call("clive2_s2q_scatter", st.ray.device, *_p(st.leaf),
                 ctypes.c_int64(st.n), *_p(st.cursor, st.queue))
    scatter_by_leaf.launches += 1


def plan_tiles(st):
    """The plan kernel (plan_tiles_plain's contract)."""
    from .. import kernels

    kernels.call("clive2_s2q_plan", st.ray.device, *_p(st.hist),
                 ctypes.c_int(st.hist.numel()),
                 *_p(st.offs, st.cursor, st.info))
    plan_tiles.launches += 1


def bin_by_leaf(st):
    """The binning kernels (bin_by_leaf_plain's contract, any order within
    a fat leaf)."""
    count_by_leaf(st)
    plan_tiles(st)
    scatter_by_leaf(st)


def leaf_test(st, tables, instance=LEAF_TEST, keep=None):
    """The leaf-test kernel (leaf_test_plain's contract): ``instance``
    "tf32" (prefiltered) or "fp32" (every slot exact); ``keep``, an i32
    [st.max_tiles * TILE, 4] tensor, receives the prefilter's survivor
    masks of the queue's entries."""
    from .. import kernels

    kernels.call(_LEAF_ENTRIES[instance], st.ray.device,
                 *_p(st.queue, st.info, st.hist, st.offs),
                 ctypes.c_int64(st.max_tiles),
                 *_p(st.leaf, st.ray, st.bt, st.bc, tables["feat"],
                     tables["fat_start"]),
                 ctypes.c_void_p(None if keep is None else keep.data_ptr()))
    leaf_test.launches += 1


def stream2_tail(st, tables, any_hit, out):
    """The tail kernel: the per-thread walk from the saved state, then the
    outputs (PlainSteps.tail's contract)."""
    from .. import kernels

    kernels.call("clive2_stream2_tail", st.ray.device, ctypes.c_int64(st.n),
                 *_p(st.ray, st.bt, st.bc, st.ref, st.sp, st.stack_ref,
                     st.stack_t, tables["nodebox"], tables["childs"],
                     tables["feat"], tables["fat_start"], tables["slot_tri"],
                     tables["slot_mt"]), ctypes.c_int(int(any_hit)),
                 *_p(*out))
    stream2_tail.launches += 1


for _fn in (stream2_thread, walk_to_leaf, count_by_leaf, plan_tiles,
            scatter_by_leaf, leaf_test, stream2_tail):
    _fn.launches = 0


class KernelSteps(PlainSteps):
    """The queued traversal's steps as kernel launches."""

    def __init__(self, tables, any_hit, instance=LEAF_TEST):
        super().__init__(tables, any_hit)
        self.instance = instance
        self.side = None

    def walk(self, st, rays=None):
        walk_to_leaf(st, self.tables, self.any_hit, rays)

    def bin(self, st):
        """The binning kernels, and a copy of the round's (live rays,
        tiles) into pinned host memory that the returned function waits
        for."""
        bin_by_leaf(st)
        return self.read_info(st)

    @staticmethod
    def read_info(st):
        """A copy of ``st.info`` to pinned host memory, and the function
        that waits for it and returns it."""
        host = torch.empty(2, dtype=torch.int32, pin_memory=True)
        host.copy_(st.info, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def read():
            done.synchronize()
            return tuple(host.tolist())

        return read

    def leaf_test(self, st):
        leaf_test(st, self.tables, self.instance)

    def side_stream(self, device):
        """The stream the tails run on (made at first use)."""
        if self.side is None:
            self.side = torch.cuda.Stream(device)
        return self.side

    def tail(self, st, out):
        """The tail kernel on a side stream: a chunk's last rays (a few
        long walks, on a few SMs) overlap the next chunk's rounds and the
        host reads between them.  The state and the outputs are marked in
        use by that stream, so the allocator keeps them until it is done."""
        side = self.side_stream(st.ray.device)
        side.wait_stream(torch.cuda.current_stream(st.ray.device))
        with torch.cuda.stream(side):
            stream2_tail(st, self.tables, self.any_hit, out)
        for t in (*(getattr(st, f.name) for f in dataclasses.fields(st)),
                  *out):
            t.record_stream(side)

    def join(self):
        """The caller's stream waits for the tails."""
        if self.side is not None:
            torch.cuda.current_stream(self.side.device).wait_stream(self.side)


def kernel_args(origin, direction, scene, active=None, t_max=None):
    """A cast's validated kernel arguments: (``kernels.RayArgs``, the
    ``stream2`` tables on the rays' device, the outputs to fill)."""
    from .. import kernels

    tables = scene["stream2"]
    kernels.check_tables(tables, _KERNEL_TABLES, "stream2")
    rays = kernels.ray_args(origin, direction, active, t_max)
    tables = {k: kernels.on_device(tables[k].contiguous(), origin.device, k)
              for k in [k for k, _, _ in _KERNEL_TABLES] + ["depth"]}
    return rays, tables, kernels.hit_outputs(origin)


def intersect_stream2(origin, direction, scene, active=None, t_max=None,
                      any_hit=False):
    """Closest hit (or, with ``any_hit``, a hit under ``t_max``) of the
    scene's BVH triangles through its ``stream2`` tables; the sensor plane
    is not in the tree.

    CPU tensors take the plain version; CUDA tensors launch the queued
    traversal's kernels (a cast of fewer than ``QUEUE_MIN`` rays the
    per-thread kernel) and raise if they cannot launch.  The queued path
    leaves its (rounds, rays left to the tail) in
    ``intersect_stream2.last``.  ``intersect_stream2.launches`` counts the
    casts that launched a kernel (each kernel counts its own launches).
    """
    if origin.device.type == "cpu":
        return stream2_plain(origin, direction, scene["stream2"],
                             active=active, t_max=t_max, any_hit=any_hit)
    rays, tables, out = kernel_args(origin, direction, scene, active, t_max)
    intersect_stream2.last = None
    if rays.n >= QUEUE_MIN:
        stats = queued_cast((rays.origin, rays.direction, rays.active,
                             rays.t_max), KernelSteps(tables, any_hit), out)
        intersect_stream2.last = dict(zip(("rounds", "tail_rays"), stats))
        intersect_stream2.launches += 1
    elif rays.n:
        stream2_thread(rays, tables, any_hit, out)
        intersect_stream2.launches += 1
    return out


intersect_stream2.launches = 0
intersect_stream2.last = None
