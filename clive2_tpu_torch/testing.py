"""Inputs that hold the kernels to their rules: a soup of triangles that
each appear twice, so that every hit is an exact tie in t (the traversal
kernels' tie rule, and the packet walk's inside a leaf:
``leaf_tie_winner``), and rays at the edges of the brute-force test;
rays and a deep tree at the packet walk's edges (``packet_edge_rays``, ``deep_bvh2_tables``); ``launch_counters``
and ``check_launches``,
which tell which kernels a render ran; ``CastLog``, ``differing_slots``,
``reached_pixels`` and ``splat_pixels``, which find the pixels two
renders of one sample may differ on because some cast answered
differently (near ties); and
``spawn_ranks``, which runs a function on the ranks of a gloo process
group in spawned processes, under a time limit (the tile mesh's tests).

Used by the CPU tests (with the JAX package's tree) and by chip_smoke.py
and the card tests (with the port's tree).
"""

from __future__ import annotations

import os
import time

import numpy as np

from .constants import MAX_BOUNCES

# the queued fat-leaf traversal's own kernels (intersect_stream2.launches
# counts its casts), and the plain versions that no render on the card runs
STREAM2_KERNELS = ("stream2_walk", "stream2_count", "stream2_plan",
                   "stream2_scatter", "stream2_leaf", "stream2_tail",
                   "stream2_thread")
PLAIN_VERSIONS = ("brute_plain", "gather_walk", "stream2_plain",
                  "wide_plain", "stream_plain", "packet_walk_plain",
                  "link_probe_plain", "slab_copy_plain", "matmul_t_plain",
                  "matmul_plain", "connect_rays_plain",
                  "connect_shade_plain", "rng_uniform_plain",
                  "rng_fold_in_plain", "rng_split_plain",
                  "trace_shade_plain")
# the connection's kernels, which every render on the card launches (once
# each a connect_paths) whatever its cast kernel, and their plain
# versions, which only connect_paths(debug_per_strategy=True) runs there
CONNECT_KERNELS = ("connect_rays", "connect_shade")
CONNECT_PLAIN = ("connect_rays_plain", "connect_shade_plain")
# the RNG's kernels, which every render on the card launches (once a draw,
# a fold_in or a split), and their plain versions, which no render there
# runs
RNG_KERNELS = ("rng_uniform", "rng_keys")
RNG_PLAIN = ("rng_uniform_plain", "rng_fold_in_plain", "rng_split_plain")
# the trace's shading kernel, which every render on the card launches (once
# a bounce), and its plain version, which no render there runs
TRACE_KERNELS = ("trace_shade",)
TRACE_PLAIN = ("trace_shade_plain",)


def launch_counters():
    """{name: (function, attribute)} of every count that tells which
    kernels a render ran: the ``launches`` of each cast's kernel wrapper
    and of the queued fat-leaf traversal's kernels (STREAM2_KERNELS), and
    the ``calls`` of each plain version (PLAIN_VERSIONS)."""
    from . import rng
    from .integrator import connect, trace
    from .ops import (brute, intersect, link_probe, mosaic_probes as mp,
                      packet_walk, traverse_bvh2, traverse_stream,
                      traverse_stream2 as s2, traverse_wide)

    kernels = dict(brute=brute.intersect_brute,
                   bvh2=traverse_bvh2.intersect_bvh2,
                   stream2=s2.intersect_stream2,
                   wide=traverse_wide.intersect_wide,
                   stream=traverse_stream.intersect_stream,
                   stream2_walk=s2.walk_to_leaf,
                   stream2_count=s2.count_by_leaf,
                   stream2_plan=s2.plan_tiles,
                   stream2_scatter=s2.scatter_by_leaf,
                   stream2_leaf=s2.leaf_test, stream2_tail=s2.stream2_tail,
                   stream2_thread=s2.stream2_thread,
                   packet_walk=packet_walk.packet_walk,
                   link_probe=link_probe.scale_shift,
                   slab_copy=mp.slab_copy, matmul_t=mp.matmul_t,
                   matmul=mp.matmul, connect_rays=connect.rays_kernel,
                   connect_shade=connect.shade_kernel,
                   rng_uniform=rng.uniform_kernel, rng_keys=rng.keys_kernel,
                   trace_shade=trace.shade_kernel)
    plain = dict(brute_plain=brute.brute_plain,
                 gather_walk=intersect.intersect_bvh_packed,
                 stream2_plain=s2.stream2_plain,
                 wide_plain=traverse_wide.wide_plain,
                 stream_plain=traverse_stream.stream_plain,
                 packet_walk_plain=packet_walk.packet_walk_plain,
                 link_probe_plain=link_probe.scale_shift_plain,
                 slab_copy_plain=mp.slab_copy_plain,
                 matmul_t_plain=mp.matmul_t_plain,
                 matmul_plain=mp.matmul_plain,
                 connect_rays_plain=connect.connection_rays_plain,
                 connect_shade_plain=connect.shade_plain,
                 rng_uniform_plain=rng.random_bits_plain,
                 rng_fold_in_plain=rng.fold_in_plain,
                 rng_split_plain=rng.split_plain,
                 trace_shade_plain=trace.shade_plain)
    return {**{k: (fn, "launches") for k, fn in kernels.items()},
            **{k: (fn, "calls") for k, fn in plain.items()}}


def check_launches(label, kernel, ran, compared=()):
    """Raise unless every kernel named in ``kernel`` ran (``ran``: counts by
    the names of ``launch_counters``), no plain version ran but those named
    in ``compared`` (a tool that holds its kernels to them), and no other
    kernel ran (with ``stream2``, the queued kernels may; the connection's,
    the RNG's and the trace's shading kernels always may)."""
    idle = [k for k in kernel if ran[k] <= 0]
    if idle:
        raise AssertionError(f"{label}: the {idle} kernels never ran")
    if any(ran[k] for k in PLAIN_VERSIONS if k not in compared):
        raise AssertionError(f"{label}: a plain version ran: {ran}")
    allowed = (set(kernel) | set(CONNECT_KERNELS) | set(RNG_KERNELS)
               | set(TRACE_KERNELS)
               | (set(STREAM2_KERNELS) if "stream2" in kernel else set()))
    if any(v for k, v in ran.items()
           if k not in PLAIN_VERSIONS and k not in allowed):
        raise AssertionError(f"{label}: another kernel ran: {ran}")


def differing_slots(casts_a, casts_b, lorder=None):
    """[M] bool: the camera lanes of one sample any of whose casts (its
    camera ray's, its paired light ray's, its connections') answered
    differently in two renders.  ``casts_a``/``casts_b``: the sample's
    casts in order, as numpy arrays, the merged trace's [2M] (camera lanes,
    then light lanes) and the connection's [P * M]; ``lorder``: the light
    order of a Morton wavefront (traced light lane j holds the light ray
    generated at ``lorder[j]``), None in raster order."""
    m = np.asarray(casts_a[0]).size // 2
    slot = np.zeros(m, bool)
    for a, b in zip(casts_a, casts_b):
        diff = np.asarray(a) != np.asarray(b)
        if diff.size == 2 * m:            # merged camera+light trace
            light = diff[m:]
            if lorder is not None:
                light = light[np.argsort(lorder)]
            slot |= diff[:m] | light
        else:                             # [P, M] connection cast
            slot |= diff.reshape(-1, m).any(0)
    return slot


def reached_pixels(slot, lanes, splats, width, height):
    """[H, W] bool: the pixels lanes ``slot`` reach: the 3x3 filter
    footprint of each one's pixel (``lanes``: lane -> flat pixel) and the
    pixels its t=1 strategies splat onto (``splats``: the sample's splat
    pixel arrays, [M] each, W*H for a dropped splat)."""
    n = width * height
    seed = np.zeros(n, bool)
    seed[np.asarray(lanes)[slot]] = True
    img = np.pad(seed.reshape(height, width), 1)
    near = np.zeros((height, width), bool)
    for dy in range(3):
        for dx in range(3):
            near |= img[dy:dy + height, dx:dx + width]
    for pix in splats:
        pix = np.asarray(pix)[slot]
        near.ravel()[pix[pix < n]] = True
    return near


def splat_pixels(cam_path, light_path, scene, cast_tri, cast_t, cast_active,
                 width, height, max_bounces=MAX_BOUNCES):
    """The pixel each lane's t=1 strategy (1, s) splats onto, W*H for a
    dropped splat: [N] each, s = 1 .. max_bounces, from the plain
    ``connect._strategy_t1`` on the arguments of ``connect.shade``."""
    from .integrator import connect

    CV, LV = cam_path["vertices"], light_path["vertices"]
    pre = connect.precompute_mis(CV, LV, scene["mat"])
    return [connect._strategy_t1(1, s, CV, LV, scene, width, height,
                                 cast_tri[s - 1], cast_t[s - 1],
                                 cast_active[s - 1], pre)[0]
            for s in range(1, max_bounces + 1)]


class CastLog:
    """Records one render's casts through the integrator, to compare two
    renders of the same sample cast for cast (two traversal routes, say):
    per cast the triangle ids it returns, or for an any-hit cast its
    verdicts (two traversals may stop at different occluders); per t=1
    strategy its splat pixels; per sample the lane -> pixel map and the
    light order.  A context manager around the render; ``near(other,
    sample)`` gives the pixels the two may differ on and the lanes whose
    casts differ."""

    def __init__(self):
        self.casts, self.splats = [], []
        self.pixels, self.light_orders = [], []
        self._lorder = None

    def __enter__(self):
        import contextlib

        from .integrator import connect, render, trace

        def cast(fn):
            def wrapped(*a, **k):
                res = fn(*a, **k)
                ids = res[0] >= 0 if k.get("any_hit") else res[0]
                self.casts.append(ids.cpu().numpy())
                return res
            return wrapped

        def splat(fn):
            def wrapped(*a, **k):
                res = fn(*a, **k)
                self.splats += [x.cpu().numpy() for x in splat_pixels(*a)]
                return res
            return wrapped

        def pairing(fn):
            def wrapped(lorder, *a, **k):
                self._lorder = lorder.cpu().numpy()
                return fn(lorder, *a, **k)
            return wrapped

        def weights(fn):
            def wrapped(sensor_pos, pixel_idx, *a, **k):
                self.pixels.append(pixel_idx.cpu().numpy())
                self.light_orders.append(self._lorder)
                self._lorder = None
                return fn(sensor_pos, pixel_idx, *a, **k)
            return wrapped

        self._stack = contextlib.ExitStack()
        for mod, name, wrap in ((trace, "intersect_scene", cast),
                                (connect, "intersect_scene", cast),
                                (connect, "shade", splat),
                                (render, "pair_lights", pairing),
                                (render, "filter_weights", weights)):
            orig = getattr(mod, name)
            setattr(mod, name, wrap(orig))
            self._stack.callback(setattr, mod, name, orig)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def near(self, other, sample, width, height, max_bounces=6):
        """([H, W] bool near-tie pixels, differing rays) of recorded
        sample ``sample`` between this render and ``other``."""
        per = max_bounces + 1
        a = self.casts[sample * per:(sample + 1) * per]
        b = other.casts[sample * per:(sample + 1) * per]
        if len(a) != per or len(b) != per:
            raise ValueError(f"sample {sample}: {len(a)} and {len(b)} "
                             f"casts recorded, expected {per}")
        slot = differing_slots(a, b, self.light_orders[sample])
        if other.light_orders[sample] is not None and not np.array_equal(
                other.light_orders[sample], self.light_orders[sample]):
            raise ValueError("the two renders traced the lights in "
                             "different orders")
        if not np.array_equal(self.pixels[sample], other.pixels[sample]):
            raise ValueError("the two renders' lanes hold other pixels")
        splats = [x for log in (self, other) for x in
                  log.splats[sample * max_bounces:(sample + 1)
                             * max_bounces]]
        rays = sum(int((np.asarray(x) != np.asarray(y)).sum())
                   for x, y in zip(a, b))
        return reached_pixels(slot, self.pixels[sample], splats, width,
                              height), rays


def mesh_render(rank, size, workdir, device, jobs):
    """A rank of ``spawn_ranks``: for each job ``(name, preset, width,
    height, seed, samples)`` build the preset on ``device`` and
    render ``samples`` samples with ``Renderer(mesh=)``, then write the
    state, each sample's seconds and every count of ``launch_counters``
    (``launches/`` + its name) to ``{workdir}/{name}-rank{rank}.npz`` (its
    accumulators are the same on every rank)."""
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch.parallel import make_tile_mesh

    counters = launch_counters()
    mesh = make_tile_mesh(devices=device)
    for name, preset, width, height, seed, samples in jobs:
        scene = ct.create_scene_from_preset(preset, width, height,
                                            device=device)
        r = ct.Renderer(scene, seed=seed, mesh=mesh)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        seconds = []
        for _ in range(samples):
            mesh.barrier()
            t0 = time.perf_counter()
            r.run_sample()
            r.block()
            seconds.append(time.perf_counter() - t0)
        np.savez(os.path.join(workdir, f"{name}-rank{rank}.npz"),
                 seconds=np.asarray(seconds),
                 **{f"launches/{k}": getattr(fn, attr)
                    for k, (fn, attr) in counters.items()},
                 **{k: v.cpu().numpy() for k, v in r.state.items()})
        del r, scene
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def _rank_main(rank, fn, size, workdir, args):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=size)
    try:
        fn(rank, size, workdir, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, size: int, workdir: str, args=(), timeout=300.0):
    """Run ``fn(rank, size, workdir, *args)`` in ``size`` spawned
    processes, each a rank of a gloo group initialised from a file in
    ``workdir`` (an empty directory), and wait for them.  ``fn`` must be
    importable by name.  Raises when a rank fails, or kills every rank and
    raises ``TimeoutError`` when they outlast ``timeout`` seconds."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(fn, size, workdir, args),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{size} ranks of {fn.__name__} outlasted "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


# A ray whose tie the traversals once broke by their visit order: in the
# teapots scene (the ``teapots`` preset with the port's
# ``models.utah_teapot(n=10)`` as teapot.obj, as chip_smoke.py writes it) it
# hits triangles 1439 and 1549 at one t, on their shared edge, and the slab
# entry of 1549's leaf box (the lower slot) rounds an ulp past that t
# (ops/intersect.py:cull_bound).  Origin, direction and cap as f32 bits.
ULP_TIE_RAY = dict(o=[-1056270224, 1084563974, -1054867456],
                   d=[1059311587, -1101212673, 1060950647], t_max=1103344237,
                   tied=(1439, 1549), want=1549)


def write_assets(resource_dir):
    """Write the meshes the presets read that are missing from
    ``resource_dir``, with the port's generator
    (``scripts/make_assets.py``).  Returns {file: seconds, or None when the
    file was there}."""
    from .scripts.make_assets import MESHES, write_mesh

    out = {}
    for name, _ in MESHES:
        out[name] = None
        if os.path.exists(os.path.join(resource_dir, name)):
            continue
        t0 = time.perf_counter()
        write_mesh(resource_dir, name)
        out[name] = time.perf_counter() - t0
    return out


def teapots_scene(workdir, width, height, device):
    """The ``teapots`` preset with its teapot.obj written into ``workdir``
    by the port's generator."""
    from . import create_scene
    from .load import write_obj
    from .models import utah_teapot
    from .scene import scene_presets

    path = os.path.join(str(workdir), "teapot.obj")
    write_obj(path, *utah_teapot(n=10))
    preset = scene_presets["teapots"]
    return create_scene(
        pixel_width=width, pixel_height=height,
        cam_center=preset["cam_center"],
        cam_direction=preset["cam_direction"], device=device,
        file_specs=[dict(spec, file_path=path)
                    for spec in preset["file_specs"]])


def swap_pair_ids(leaf_packed, t, rng):
    """Swap the ids of a random half of the pairs in the gather walk's leaf
    rows of a soup whose triangle i + t is a copy of triangle i (i < t), so
    that the lower slot (leaf * 8 + k) does not always hold the lower id.

    Returns (leaf rows, lower): ``lower(ids)`` is the id at the lower slot
    of each id's pair, the id the tie rule must report."""
    flat = np.asarray(leaf_packed).reshape(-1, 10).copy()
    swap = np.arange(2 * t)
    half = np.nonzero(rng.uniform(size=t) < 0.5)[0]
    swap[half], swap[half + t] = half + t, half
    filled = flat[:, 9] >= 0
    geom = flat[filled, 9].astype(np.int64)         # geometry of each slot
    flat[filled, 9] = swap[geom]
    slot_of = np.empty(2 * t, np.int64)             # geometry -> slot
    slot_of[geom] = np.nonzero(filled)[0]

    def lower(ids):
        k = swap[ids] % t                           # the pair hit
        return swap[np.where(slot_of[k] < slot_of[k + t], k, k + t)]

    return flat.reshape(np.shape(leaf_packed)), lower


def leaf_tie_winner(leaf_packed, ids):
    """The id the packet walk (ops/packet_walk.py) must report for each hit
    ``ids`` [N] on a soup whose triangles come in identical pairs
    (``tie_soup``): where both copies of the hit pair lie in one leaf of the
    gather walk's rows ``leaf_packed``, the larger id (the walk's rule
    inside a leaf); -1 where the pair spans two leaves (the leaf the packet
    visits first wins, strictly smaller t being needed to replace) or the
    ray missed."""
    slots = np.shape(leaf_packed)[1] // 10
    flat = np.asarray(leaf_packed).reshape(-1, 10)
    real = np.nonzero(flat[:, 9] >= 0)[0]
    leaf_of = dict(zip(flat[real, 9].astype(np.int64), real // slots))
    pairs = {}
    for slot in real:
        pairs.setdefault(flat[slot, :9].tobytes(), []).append(
            int(flat[slot, 9]))
    partner = {}
    for a, b in (p for p in pairs.values() if len(p) == 2):
        partner[a], partner[b] = b, a
    out = np.full(len(ids), -1, np.int64)
    for i, k in enumerate(np.asarray(ids)):
        if k >= 0 and leaf_of[partner[k]] == leaf_of[k]:
            out[i] = max(k, partner[k])
    return out


def tie_soup(seed, t):
    """The port's gather-walk rows of a soup of ``t`` random triangles
    (centres in [-5, 5]^3, vertices within 0.4) each twice, with the ids of
    half of the pairs swapped (``swap_pair_ids``).  Returns (rows,
    lower)."""
    from .bvh.build import build_bvh, leaf_tables
    from .geometry import TriangleSoup
    from .ops.intersect import pack_gather_walk

    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (t, 1, 3))
    base = (c + rng.uniform(-0.4, 0.4, (t, 3, 3))).astype(np.float32)
    soup = TriangleSoup.from_vertices(np.concatenate([base, base]))
    bvh = build_bvh(soup)
    rows = pack_gather_walk(bvh, leaf_tables(bvh, soup))
    rows["leaf_packed"], lower = swap_pair_ids(rows["leaf_packed"], t, rng)
    return rows, lower


PACKET_EDGE_RAYS = ("faces", "far", "one_warp")


def packet_edge_rays(nodes, kind, n, seed):
    """Rays at the packet walk's edges (csrc/packet_walk.cu's note) on the
    BVH2 node records ``nodes`` [I, 16] (numpy): (origin, direction [n,
    3] f32, active [n] bool, t_max [n] f32).

    * ``faces``: each origin on a face of a random node's child box, the
      direction along a random axis, either sign, its other components
      +0.0 or -0.0: slab entries of exactly +0.0 and -0.0;
    * ``far``: t_max inf, origins 1e9 off the scene on some axes (a
      third of them below it on every axis), directions along an axis, zero
      or random: entries that overflow to +inf, and zero directions hit
      every box with an entry of +inf;
    * ``one_warp``: rays aimed into the scene of which only one warp of
      each 128-ray group is active, a different warp in successive
      groups."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nodes = np.asarray(nodes, f32)
    if kind == "faces":
        side = rng.integers(0, 2, n)[:, None]
        k = rng.integers(0, len(nodes), n)
        lo = np.where(side, nodes[k][:, [4, 6, 10]], nodes[k][:, [0, 2, 8]])
        hi = np.where(side, nodes[k][:, [5, 7, 11]], nodes[k][:, [1, 3, 9]])
        o = (lo + (hi - lo) * rng.uniform(size=(n, 3))).astype(f32)
        axis = rng.integers(0, 3, n)
        face = np.where(rng.integers(0, 2, n) == 1, hi[np.arange(n), axis],
                        lo[np.arange(n), axis])
        o[np.arange(n), axis] = face
        d = np.where(rng.integers(0, 2, (n, 3)) == 1, f32(-0.0), f32(0.0))
        d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
        return (o, d.astype(f32), np.ones(n, bool),
                np.full(n, np.inf, f32))
    if kind == "far":
        o = rng.uniform(-8, 8, (n, 3))
        far = rng.uniform(size=(n, 3)) < 0.4
        o = np.where(far, o + rng.choice([-1e9, 1e9], (n, 3)), o)
        below = rng.uniform(size=n) < 1 / 3
        o[below] = -1e9
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        how = rng.integers(0, 3, n)
        d[how == 1] = np.eye(3)[rng.integers(0, 3, n)][how == 1] \
            * rng.choice([-1.0, 1.0], n)[how == 1, None]
        d[(how == 2) | below] = 0.0
        return (o.astype(f32), d.astype(f32), np.ones(n, bool),
                np.full(n, np.inf, f32))
    if kind == "one_warp":
        o = rng.uniform(-8, 8, (n, 3))
        d = rng.uniform(-5, 5, (n, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        i = np.arange(n)
        t_max = np.where(rng.uniform(size=n) < 0.5, np.inf,
                         rng.uniform(2, 14, n))
        return (o.astype(f32), d.astype(f32),
                (i // 32) % 4 == (i // 128) % 4, t_max.astype(f32))
    raise ValueError(f"unknown kind {kind!r}: expected one of "
                     f"{', '.join(PACKET_EDGE_RAYS)}")


def deep_bvh2_tables(depth, seed):
    """BVH2 tables (numpy ``nodes`` [2 depth - 1, 16], ``tris`` [R, 12]) of
    a tree built by hand to fill the packet walk's stack: a spine of
    ``depth`` inner nodes, node i's child A the next spine node and its
    child B an inner node of two leaves (the last spine node's children
    are two leaves), every box [-10, 10]^3, each leaf 1-8 random triangles
    inside it.  A packet with an active ray inside the box pops every node,
    A always on top (its entries tie B's), so its stack holds depth - 1
    entries."""
    from .ops.traverse_bvh2 import LEAF_BITS, node_records

    rng = np.random.default_rng(seed)
    n_leaves = 2 * depth
    count = rng.integers(1, 9, n_leaves)
    first = np.cumsum(count) - count
    rows = int(count.sum())
    v0 = rng.uniform(-8, 8, (rows, 3))
    tris = np.zeros((rows, 12), np.float32)
    tris[:, 0:3] = v0
    tris[:, 3] = np.arange(rows)
    tris[:, 4:7] = rng.uniform(-1, 1, (rows, 3))
    tris[:, 8:11] = rng.uniform(-1, 1, (rows, 3))
    leaf = ~((first << LEAF_BITS) | count)
    inner = 2 * depth - 1
    ref_a = np.empty(inner, np.int64)
    ref_b = np.empty(inner, np.int64)
    spine = np.arange(depth - 1)
    ref_a[spine], ref_b[spine] = spine + 1, depth + spine
    ref_a[depth - 1], ref_b[depth - 1] = leaf[0], leaf[1]
    ref_a[depth:], ref_b[depth:] = leaf[2::2], leaf[3::2]
    box = np.tile(np.array([-10, -10, -10, 10, 10, 10], np.float32),
                  (inner, 1))
    return dict(nodes=node_records(box, box, ref_a.astype(np.int32),
                                   ref_b.astype(np.int32)), tris=tris)


def brute_edge_cases():
    """Rays at the edges of the brute-force test, built by hand, and the
    two triangles they are built for: (origins [N, 3], directions [N, 3],
    brute table [2, 10]), all f32.  Ray 0 hits
    triangle 1 with u = f U underflowing to -0.0, which a test of U's sign
    alone would reject."""
    f32 = np.float32
    big = f32(2.0 ** 60)
    unit = np.array([[0, 0, 0, 1, 0, 0, 0, 1, 0, 0]], f32)   # x, y plane
    huge = np.array([[0, 0, 0, big, 0, 0, 0, big, 0, 0]], f32)
    delta = f32(1e-4)
    cases = [
        # u = f U underflows to -0.0 (U < 0, a = 2^120): plain accepts
        (huge, [-(2.0 ** -149), 2.0 ** 58, 5.0], [0, 0, -1]),
        # t = f T underflows to -0.0: plain rejects (t > kDelta fails)
        (huge, [2.0 ** 58, 2.0 ** 58, -(2.0 ** -149)], [0, 0, -1]),
        # a = +0 and a = -0: rays in the triangle's plane
        (unit, [0.2, 0.2, 0.0], [1, 0, 0]),
        (unit, [0.2, 0.2, 0.0], [-1, 0, 0]),
        (unit, [0.2, 0.2, 0.0], [0, -1, 0]),
        # u exactly 0, u exactly 1, v exactly 0, u + v exactly 1
        (unit, [0.0, 0.3, 1.0], [0, 0, -1]),
        (unit, [1.0, 0.0, 1.0], [0, 0, -1]),
        (unit, [0.3, 0.0, 1.0], [0, 0, -1]),
        (unit, [0.5, 0.5, 1.0], [0, 0, -1]),
        (unit, [0.25, 0.75, 1.0], [0, 0, -1]),
        # just outside each edge, by one ulp and by about 2^-20
        (unit, [np.nextafter(f32(1), f32(2)), 0.0, 1.0], [0, 0, -1]),
        (unit, [-(2.0 ** -30), 0.5, 1.0], [0, 0, -1]),
        (unit, [0.5, np.nextafter(f32(0.5), f32(1)), 1.0], [0, 0, -1]),
        (unit, [1.0 + 2.0 ** -21, 0.0, 1.0], [0, 0, -1]),
        (unit, [1.0 + 2.0 ** -19, 0.0, 1.0], [0, 0, -1]),
        # t exactly kDelta (rejected) and just past it (accepted)
        (unit, [0.2, 0.2, delta], [0, 0, -1]),
        (unit, [0.2, 0.2, np.nextafter(delta, f32(1))], [0, 0, -1]),
        # t just below 0 and just above: behind and in front
        (unit, [0.2, 0.2, -(2.0 ** -30)], [0, 0, -1]),
        (unit, [0.2, 0.2, 1.0], [0, 0, 1]),
        # a grazing ray (tiny a) and a ray from below (a < 0)
        (unit, [0.2, 0.2, 1.0], [0, 2.0 ** -40, -1]),
        (unit, [0.2, 0.3, -1.0], [0, 0, 1]),
        (unit, [0.2, 0.3, 1.0], [2.0 ** -100, 0, -(2.0 ** -100)]),
    ]
    o = np.array([c[1] for c in cases], f32)
    d = np.array([c[2] for c in cases], f32)
    return o, d, np.concatenate([unit, huge])
