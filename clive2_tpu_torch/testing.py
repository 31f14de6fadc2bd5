"""Inputs that hold the kernels to their rules: a soup of triangles that
each appear twice, so that every hit is an exact tie in t (the traversal
kernels' tie rule), and rays at the edges of the brute-force test and of
its early-reject pre-test; ``launch_counters`` and ``check_launches``,
which tell which kernels a render ran; and ``spawn_ranks``, which runs a
function on the ranks of a gloo process group in spawned processes, under
a time limit (the tile mesh's tests).

Used by the CPU tests (with the JAX package's tree) and by chip_smoke.py
and the card tests (with the port's tree).
"""

from __future__ import annotations

import os
import time

import numpy as np


# the queued fat-leaf traversal's own kernels (intersect_stream2.launches
# counts its casts), and the plain versions that no render on the card runs
STREAM2_KERNELS = ("stream2_walk", "stream2_count", "stream2_plan",
                   "stream2_scatter", "stream2_leaf", "stream2_tail",
                   "stream2_thread")
PLAIN_VERSIONS = ("brute_plain", "gather_walk", "stream2_plain",
                  "wide_plain", "stream_plain")


def launch_counters():
    """{name: (function, attribute)} of every count that tells which
    kernels a render ran: the ``launches`` of each cast's kernel wrapper
    and of the queued fat-leaf traversal's kernels (STREAM2_KERNELS), and
    the ``calls`` of each plain version (PLAIN_VERSIONS)."""
    from .ops import (brute, intersect, traverse_bvh2, traverse_stream,
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
                   stream2_thread=s2.stream2_thread)
    plain = dict(brute_plain=brute.brute_plain,
                 gather_walk=intersect.intersect_bvh_packed,
                 stream2_plain=s2.stream2_plain,
                 wide_plain=traverse_wide.wide_plain,
                 stream_plain=traverse_stream.stream_plain)
    return {**{k: (fn, "launches") for k, fn in kernels.items()},
            **{k: (fn, "calls") for k, fn in plain.items()}}


def check_launches(label, kernel, ran):
    """Raise unless every kernel named in ``kernel`` ran (``ran``: counts by
    the names of ``launch_counters``), no plain version ran, and no other
    kernel ran (with ``stream2``, the queued kernels may)."""
    idle = [k for k in kernel if ran[k] <= 0]
    if idle:
        raise AssertionError(f"{label}: the {idle} kernels never ran")
    if any(ran[k] for k in PLAIN_VERSIONS):
        raise AssertionError(f"{label}: a plain version ran: {ran}")
    allowed = set(kernel) | (set(STREAM2_KERNELS) if "stream2" in kernel
                             else set())
    if any(v for k, v in ran.items()
           if k not in PLAIN_VERSIONS and k not in allowed):
        raise AssertionError(f"{label}: another kernel ran: {ran}")


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


def brute_edge_cases():
    """Rays at the edges of the brute-force test and of its early-reject
    pre-test (csrc/brute.cu's note), built by hand, and the two triangles they are built for: (origins [N,
    3], directions [N, 3], brute table [2, 10]), all f32.  Ray 0 hits
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
        # just outside each edge, by one ulp and by the margin
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
