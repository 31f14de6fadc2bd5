"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clive2_tpu_torch/csrc, holds each
against its plain PyTorch version on the card (on synthetic ray sets, then
on the casts the main path itself gives the kernel, recorded from one
sample of each configuration; the queued fat-leaf traversal also kernel by
kernel on one round of the first chunk of each of its casts), times both on
those casts (and, on the BVH scenes' casts, the other kernels that can carry
the scene as an A/B: on the fat-leaf casts also the per-thread fat-leaf
kernel, the FP32-only leaf test and other tail sizes), holds the BVH2, BVH8
and streaming kernels to a soup of exact ties, reports what an exact
early-reject pre-test would end on the brute casts (by lane and by warp), a
development build of it with ``--fmad=true`` beside the exact one, and the
SASS instructions per triangle test, and the persistent traversal kernels'
registers, shared memory, spills and resident blocks, then
renders the main-path configurations through ``create_scene_from_preset``
-> ``Renderer.run_sample()`` with launch counters proving which kernel
carried every cast, 2 samples each: Cornell ``empty`` at 1920x1080 and
``teapots`` at 512x512 (brute and BVH2 kernels); ``medium-dragon`` at
512x512 and ``sponza`` at 1920x1080 (the queued fat-leaf traversal, and
on the medium dragon's small extension casts the per-thread fat-leaf
kernel), each followed by the same render on BVH2 tables as an A/B; and the
JAX package's two A/B
traversal paths: ``dragon`` at 512x512 under ``CLIVE2_TRAVERSAL=wide``
(BVH8 kernel), ``medium-dragon`` at 512x512 under ``CLIVE2_STREAM_IMPL=1``
and ``sponza`` at 1920x1080 on the same tables (streaming kernel).  Then
the integrator's other paths, each with its own launch counts: the
reference estimator (``CLIVE2_REFERENCE_MIS``) on Cornell 1080p and teapots
512, 2 samples each, its closest-hit connection casts held to their plain
versions, and a 64x64 render on the card against the CPU's; the statistical
oracles (``clive2_tpu_torch.oracles``) with their bounds; adaptive sampling
on Cornell 1080p (2 uniform, 2 adaptive samples at a quarter of the pixels),
its subset casts held to plain; and row stripes: sponza 1080p full-frame and
in 54-row stripes (peak memory of each; the stripe casts held to plain on
every k-th ray) and Cornell 3840x2160 in 270-row stripes.  Then camera
moves (``movie``: teapots 1280x720, 3 orbit frames at 2 spp, frames 1-2
through ``Scene.with_camera``, frame 2 against a full rebuild and its BVH2
connection cast held to plain; a Cornell 1080p ``with_camera`` frame, its
moved brute table's connection cast held to plain), tile meshes
(``tiles``: ``Renderer(mesh=)`` on an NCCL group of one rank, and on two
gloo ranks on the one card, spawned under a time limit, each against one
device, or in Morton order the two ranks against their tiles rendered on
one device), and the two CLIs as subprocesses (``cli``).  The wave order
(``wave_order``): the mesh cells in raster, auto (morton) and morton
order without per-cast sorts, each kernel's depth-0, depth-3 and
connection casts in raster, Morton wave and Morton-key order with the
sort's steps timed apart, the card's busy share over one sample
(``utils.profiling.trace_to``), a ``CLIVE2_CONNECT_K=4`` sample against the
full cast and a 64x64 teapots morton render on the card against the CPU's.
The mesh cells' default order is auto, so under ``slice`` the BVH scenes
render in Morton order.  Then it compares a small render on the card with
the same render on the CPU.  The
meshes are written into resources/ when missing (procedural stand-ins at
the reference's triangle counts, as scripts/make_assets.py makes them).  Each
phase prints one JSON line; any failure exits non-zero without the final
line.  Before the last line it prints the ``kernels`` line (each kernel's
launches on the main path, error, time, plain time, the time of the one
PyTorch call that computes the same function where there is one, and the
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s of FP32, counted from the work the plain walks
did in one call) and the card's name and power limit.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports no JAX.

    python3 chip_smoke.py --sass LIBRARY

prints the SASS figures of a built kernel library (any checkout's
``clive2_tpu_torch/build/*.so``) and exits, so that two builds can be
compared on one machine.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time


ROOT = os.path.dirname(os.path.abspath(__file__))
# the bound's rates (H100 SXM, 700 W) and operations per unit of work the
# plain walks count (ops/intersect.py:WORK), from the kernels' sources: a
# slab test of one AABB (common.cuh:box_entry: 6 subtractions, 6
# multiplications, 12 min/max, 1 compare), a Möller-Trumbore test
# (common.cuh:moller_trumbore) and a bilinear slot test
# (stream2.cuh:slot_test)
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
OPS = dict(boxes=25, triangles=50, slots=40)


def emit(**kv):
    print(json.dumps(kv), flush=True)


def work_ops(work, scale=1):
    """Operations of the work a plain walk counted, times ``scale``."""
    return scale * sum(OPS[k] * v for k, v in work.items())


def bound(nbytes, ops):
    """The least time the card could take: (ms, what binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cast_bytes(c, tables):
    """Bytes a cast must move: each ray's origin, direction, active flag
    and cap read once, its id, t, u, v written once, the tables read once."""
    n = c["origin"].shape[0]
    return n * (12 + 12 + 1 + 4 + 16) + table_bytes(tables)


def cuda_time(fn, iters: int):
    """Mean milliseconds per call over ``iters`` calls after one warm-up,
    timed with CUDA events, and the last call's result."""
    import torch

    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def plain_time(fn):
    """One call of a plain version timed with CUDA events, the work it
    counted (ops/intersect.py:WORK) cleared before it: (ms, output,
    work)."""
    import torch

    from clive2_tpu_torch.ops.intersect import WORK

    WORK.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out, dict(WORK)


def record_casts(module, wrapper, renderer, run=None, calls=None):
    """Run one sample of ``renderer`` (``run()`` when given, else
    ``renderer.run_sample()``) with the kernel wrapper ``module.<wrapper>``
    keeping a copy of the inputs of the first cast of each ray count it is
    given, or with ``calls`` of the calls of those indices (0 the first);
    returns {ray count (call index): inputs}."""
    fn = getattr(module, wrapper)
    casts = {}
    seen = [0]

    def record(origin, direction, tables, active=None, t_max=None,
               any_hit=False):
        at = origin.shape[0] if calls is None else seen[0]
        seen[0] += 1
        if at not in casts and (calls is None or at in calls):
            casts[at] = dict(
                origin=origin.clone(), direction=direction.clone(),
                active=None if active is None else active.clone(),
                t_max=None if t_max is None else t_max.clone(),
                any_hit=any_hit)
        kw = dict(any_hit=any_hit) if any_hit else {}
        return fn(origin, direction, tables, active=active, t_max=t_max, **kw)

    # the wrapper counts its launches on the name it has in its module
    record.launches = fn.launches
    setattr(module, wrapper, record)
    try:
        (run or renderer.run_sample)()
        renderer.block()
    finally:
        setattr(module, wrapper, fn)
        fn.launches = record.launches
    return casts


def strided(cast, stride):
    """Every ``stride``-th ray of a recorded cast, from the first to the
    last."""
    return {k: v if k == "any_hit" or v is None else v[::stride]
            for k, v in cast.items()}


def held_cast(label, c, kernel_fn, plain_fn, tables, stride=1):
    """A recorded cast ``c`` through its kernel (mean of 5 launches on the
    whole cast) and its plain version (one call on every ``stride``-th
    ray), the outputs compared on those rays; the figures of the cast, its
    bound counted from the plain call's work."""
    import torch

    rays = c["origin"].shape[0]
    ms, got = cuda_time(lambda: kernel_fn(c), 5)
    part = strided(c, stride)
    plain_ms, want, work = plain_time(lambda: plain_fn(part))
    e = compare_hits(tuple(x[::stride] for x in got), want, label,
                     closest=not c["any_hit"])
    b_ms, b_by = bound(cast_bytes(c, tables), work_ops(work, stride))
    out = dict(rays=rays, any_hit=c["any_hit"],
               active=rays if c["active"] is None
               else int(c["active"].sum()),
               capped=c["t_max"] is not None, ms=ms, plain_ms=plain_ms,
               plain_rays=part["origin"].shape[0], compared_stride=stride,
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
               max_abs_err_t=e, matches_plain=True)
    del got, want, part
    torch.cuda.empty_cache()
    return out


def with_traversal(scene, traversal):
    """``scene`` with the tables of ``traversal`` (``wide``, ``bvh2``,
    ``stream`` or ``stream2``) in place of its own traversal tables, packed
    from its gather-walk rows by ``scene.traversal_tables``."""
    import dataclasses

    from clive2_tpu_torch import scene as scene_mod

    rows = {k: v.cpu().numpy() for k, v in scene.data["bvh"].items()}
    tables = scene_mod.traversal_tables(rows, 0, cuda=True,
                                        traversal=traversal)
    data = {k: v for k, v in scene.data.items()
            if k not in scene_mod.PACKERS}
    data.update(scene_mod.to_device(tables, scene.device))
    return dataclasses.replace(scene, data=data)


@contextlib.contextmanager
def environment(**env):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def table_bytes(tables):
    """Bytes of a kernel's tables (the root box beside them, which keys the
    Morton sort, is not the kernel's)."""
    return sum(t.numel() * t.element_size() for k, t in tables.items()
               if k not in ("lo", "hi"))


def brute_pretest(c, tris, warps=1 << 14):
    """The exact pre-test of csrc/brute.cu's note (not run by the kernel;
    ops/brute.py:pretest_stage) on every
    k-th warp of cast ``c`` (32 consecutive rays, at most ``warps`` of
    them): the share of the active lanes' triangle tests that end at each
    stage, and the share of (warp, triangle) pairs in which some active
    lane reaches each stage (a warp runs a stage when any lane does)."""
    import torch

    from clive2_tpu_torch.ops import brute

    n = c["origin"].shape[0] // 32 * 32
    k = max(1, n // 32 // warps)
    idx = (torch.arange(0, n // 32, k, device=c["origin"].device)[:, None]
           * 32 + torch.arange(32, device=c["origin"].device)).ravel()
    act = (torch.ones(idx.numel(), dtype=torch.bool, device=idx.device)
           if c["active"] is None else c["active"][idx].bool())
    stage = brute.pretest_stage(c["origin"][idx], c["direction"][idx], tris)
    lanes = stage[act].long()
    reach = torch.where(act[:, None], stage.long(), -1).reshape(
        -1, 32, tris.shape[0]).amax(1)
    return dict(
        warps=int(idx.numel() // 32), warp_stride=k,
        lane_end_share={s: float((lanes == i).float().mean())
                        for i, s in enumerate(brute.STAGES)},
        pretest_end_share=float((lanes < 3).float().mean()),
        warp_reach_share={s: float((reach >= i).float().mean())
                          for i, s in enumerate(brute.STAGES)})


def brute_fmad(c, tris, ref):
    """A development build of csrc/brute.cu with --fmad=true in place of
    --fmad=false (not used by the port), timed on cast ``c`` over 5
    launches beside the exact kernel's output ``ref``: the share of rays
    whose ids agree and the largest |t| difference where they do."""
    import torch

    from clive2_tpu_torch import kernels

    flags = ["--fmad=true" if f == "--fmad=false" else f
             for f in kernels.NVCC_FLAGS]
    so = os.path.join(kernels.BUILD_DIR, "brute_fmad_true.so")
    t0 = time.perf_counter()
    subprocess.run([kernels.nvcc(), *flags, "-shared", "-o", so,
                    os.path.join(kernels.CSRC, "brute.cu")], check=True,
                   capture_output=True, timeout=600)
    build_s = time.perf_counter() - t0
    fn = ctypes.CDLL(so).clive2_brute
    fn.argtypes = kernels._SIGNATURES["clive2_brute"]
    fn.restype = ctypes.c_int
    rays = kernels.ray_args(c["origin"], c["direction"], c["active"],
                            c["t_max"])

    def run():
        out = kernels.hit_outputs(c["origin"])
        rc = fn(*rays.pointers(), kernels.ptr(tris),
                ctypes.c_int(tris.shape[0]), *map(kernels.ptr, out),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"brute --fmad=true: CUDA error {rc}")
        return out

    ms, got = cuda_time(run, 5)
    same = got[0] == ref[0]
    hit = same & (ref[0] >= 0)
    return dict(ms=ms, build_s=build_s,
                ids_agree=float(same.float().mean()),
                max_abs_t_diff=float((got[1][hit] - ref[1][hit]).abs().max())
                if hit.any() else 0.0)


def sass_figures(library, kernels_of=("brute_kernel", "bvh2_kernel",
                                      "stream_kernel", "wide_kernel")):
    """SASS instruction counts of the named kernels in a built library
    (``cuobjdump -sass``): per kernel instance, its instructions, and for
    the innermost loop that holds a MUFU.RCP (the triangle test's
    1 / a), its instructions, its MUFU.RCPs and their ratio, the
    instructions per triangle test that reaches the division (the loop
    unrolled k times holds k of them)."""
    from clive2_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        short = next((k for k in kernels_of if k in name), None)
        if short is None:
            continue
        code = [(int(a, 16), ins.strip()) for a, ins in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        addr = [a for a, _ in code]
        loops = []
        for a, ins in code:
            m = re.search(r"\bBRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= a:
                loops.append((int(m.group(1), 16), a))
        best = None
        for lo, hi in loops:
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2 in loops):
                continue                              # not innermost
            body = [ins for a, ins in code if lo <= a <= hi]
            rcp = sum("MUFU.RCP" in ins for ins in body)
            if rcp and (best is None or len(body) > best["instructions"]):
                best = dict(instructions=len(body), mufu_rcp=rcp,
                            per_test=len(body) / rcp)
        tag = "any_hit" if "ILb1E" in name else (
            "closest" if "ILb0E" in name else "")
        out[f"{short} {tag}".strip()] = dict(instructions=len(addr),
                                             triangle_loop=best)
    return out


def tiles_on_one_device(scene, seed: int, ranks: int):
    """The state after the first sample of ``Renderer(scene, seed=seed,
    mesh=)`` over ``ranks`` ranks, computed on one device: each rank's
    tile rendered in turn in the mesh's order, its light rays sorted on
    the bounds of the whole frame's, the tiles summed."""
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.integrator import render
    from clive2_tpu_torch.integrator.trace import generate_light_rays

    w, h, data = scene.pixel_width, scene.pixel_height, scene.data
    key = rng.fold_in(rng.key(seed, device=scene.device), 0)
    order = "raster" if h % ranks else render._wave_order(data)
    lights = generate_light_rays(rng.split(key, 3)[1], data["lights"],
                                 data["mat"], w * h)["origin"]
    box = (lights.amin(0), lights.amax(0))
    parts = [render.render_sample(
        key, data, w, h, tile=(r * h // ranks,
                               (r + 1) * h // ranks - r * h // ranks),
        order=order, light_bounds=lambda lo, hi: box) for r in range(ranks)]
    sample = {k: sum(p[k] for p in parts)
              for k in ("image", "weight", "unidirectional")}
    state = render.accumulate(render.init_accumulators(
        w, h, device=scene.device), sample)
    return {k: v.cpu().numpy() for k, v in state.items()}


def write_assets(resource_dir):
    """Write the large meshes the presets read when they are missing:
    procedural stand-ins at the reference's triangle counts, with the
    transform of scripts/make_assets.py.  Returns {file: seconds or None
    when the file was there}."""
    import numpy as np

    from clive2_tpu_torch.load import write_ply
    from clive2_tpu_torch.models import displaced_blob_exact

    out = {}
    for name, count in (("dragon_vrip_res3.ply", 47_794),
                        ("dragon_vrip_res2.ply", 202_520),
                        ("sponza_scale.ply", 1_310_720)):
        path = os.path.join(resource_dir, name)
        out[name] = None
        if not os.path.exists(path):
            t0 = time.perf_counter()
            os.makedirs(resource_dir, exist_ok=True)
            v, f = displaced_blob_exact(count)
            write_ply(path, v * 0.06 + np.array([0.0, 0.085, 0.0]), f,
                      binary=True)
            out[name] = time.perf_counter() - t0
    return out


def build_timed(preset, w, h, device):
    """create_scene_from_preset with its host BVH build timed apart:
    returns (scene, total seconds, BVH build seconds)."""
    import clive2_tpu_torch as ct
    from clive2_tpu_torch import scene as scene_mod

    build_bvh = scene_mod.build_bvh
    spent = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = build_bvh(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    scene_mod.build_bvh = timed
    try:
        t0 = time.perf_counter()
        scene = ct.create_scene_from_preset(preset, w, h, device=device)
        total = time.perf_counter() - t0
    finally:
        scene_mod.build_bvh = build_bvh
    return scene, total, sum(spent)


def random_rays(n, lo, hi, gen, device):
    import torch

    o = lo + (hi - lo) * torch.rand(n, 3, generator=gen, device=device)
    d = torch.randn(n, 3, generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True)
    return o, d


def compare_hits(got, want, label, closest=True):
    """Ids equal on every ray (or, for any-hit, the same hit/miss verdict);
    t/u/v within 1e-6 on hits.  Returns the max |t| error on hits."""
    import torch

    gi, gt, gu, gv = got
    wi, wt, wu, wv = want
    if closest:
        bad = int((gi != wi).sum())
        if bad:
            raise AssertionError(f"{label}: {bad} of {gi.numel()} ids differ")
        hit = wi >= 0
        for name, a, b in (("t", gt, wt), ("u", gu, wu), ("v", gv, wv)):
            if not torch.allclose(a[hit], b[hit], rtol=1e-6, atol=1e-6):
                err = (a[hit] - b[hit]).abs().max().item()
                raise AssertionError(f"{label}: {name} differs by {err}")
        if torch.isfinite(gt[~hit]).any():
            raise AssertionError(f"{label}: finite t on a miss")
        return (gt[hit] - wt[hit]).abs().max().item() if hit.any() else 0.0
    bad = int(((gi >= 0) != (wi >= 0)).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} of {gi.numel()} any-hit "
                             "verdicts differ")
    return 0.0


def event_ms(fn, states, make):
    """Mean milliseconds of ``fn(state)`` over fresh states from
    ``make()`` (one per call; each call changes its state), timed with CUDA
    events around the call alone; returns (ms, the last state)."""
    import torch

    total = 0.0
    for _ in range(states):
        st = make()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(st)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / states, st


def same_state(a, b, label):
    """The walk's state fields equal, and the stacks below each ray's
    depth."""
    import torch

    for name in ("ray", "bt", "bc", "ref", "sp", "leaf"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            bad = int((getattr(a, name) != getattr(b, name)).sum())
            raise AssertionError(f"{label}: {name} differs on {bad} rays")
    level = torch.arange(a.stack_t.shape[0], device=a.sp.device)[:, None]
    used = level < a.sp[None, :]
    if not (torch.equal(a.stack_ref[used], b.stack_ref[used])
            and torch.equal(a.stack_t[used], b.stack_t[used])):
        raise AssertionError(f"{label}: the stacks differ")


def queue_sorted(st):
    """The queued rays, each fat leaf's sorted (the scatter kernel's order
    within a fat leaf is arbitrary)."""
    import torch

    from clive2_tpu_torch.ops import traverse_stream2 as s2

    pos, f = s2.queue_positions(st)
    return torch.sort(f * (st.n + 1) + st.queue[pos].long()).values


def stream2_parts(c, tables, label, states=3):
    """One round of the queued fat-leaf traversal on cast ``c`` (at most
    one chunk of rays), kernel by kernel against its plain step on the same
    state: the first walk, the count, plan and scatter kernels of the
    binning, both leaf-test instances, the second walk, and the tail.  Each
    kernel is timed over ``states`` fresh copies of its input state, its
    plain step once.  Returns {part: dict(ms, plain_ms, bytes, ops, ...)} and the
    prefilter's figures."""
    import torch

    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.ops import traverse_stream2 as s2
    from clive2_tpu_torch.ops.intersect import WORK

    r = kernels.ray_args(c["origin"], c["direction"], c["active"],
                         c["t_max"])
    rays = (r.origin, r.direction, r.active, r.t_max)
    n, any_hit = r.n, c["any_hit"]
    if n > s2.CHUNK:
        raise ValueError("one round of one chunk: pass at most CHUNK rays")
    steps = s2.PlainSteps(tables, any_hit)
    n_fat = tables["fat_start"].numel() - 1
    parts = {}

    def run(name, kernel, plain, before, nbytes, compare):
        """Time kernel and plain on copies of ``before``; compare; keep
        the figures.  Returns the kernel's state."""
        ms, got = event_ms(kernel, states, before.clone)
        want = before.clone()
        WORK.clear()
        plain_ms, _ = event_ms(lambda st: plain(st), 1, lambda: want)
        # the comparisons raise on a difference; the tail's returns its
        # max |t| error, the others compare exactly
        e = compare(got, want) or 0.0
        parts[name] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                           ops=work_ops(WORK), max_abs_err=e)
        return got

    empty = steps.state(n)
    walked = run("walk", lambda st: s2.walk_to_leaf(st, tables, any_hit, rays),
                 lambda st: s2.walk_to_leaf_plain(st, tables, any_hit, rays),
                 empty, n * (29 + 64 + 20),
                 lambda a, b: same_state(a, b, f"{label} walk"))
    live = int((walked.leaf >= 0).sum())

    # the binning: the count, plan and scatter kernels
    def count_plain(st):
        f = st.leaf[st.leaf >= 0].long()
        st.hist.copy_(torch.bincount(f, minlength=n_fat))

    def same(*names):
        def check(a, b):
            for name in names:
                if not torch.equal(getattr(a, name), getattr(b, name)):
                    raise AssertionError(f"{label}: {name} differs")
        return check

    counted = run("count", s2.count_by_leaf, count_plain, walked,
                  4 * (n + n_fat), same("hist"))
    parts["count"]["ops"] = live
    # the one PyTorch call that computes the same histogram: bincount of
    # the fat-leaf ids shifted by one, so that -1 (no fat leaf) falls into
    # bin 0 (the shift is made before the timing)
    shifted = walked.leaf + 1
    lib_ms, lib = cuda_time(
        lambda: torch.bincount(shifted, minlength=n_fat + 1), 5)
    if not torch.equal(lib[1:].int(), counted.hist):
        raise AssertionError(f"{label}: bincount differs from the count")
    parts["count"]["library_ms"] = lib_ms
    del shifted, lib
    planned = run("plan", s2.plan_tiles, s2.plan_tiles_plain, counted,
                  16 * n_fat, same("offs", "cursor", "info"))
    parts["plan"]["ops"] = 2 * n_fat

    def scatter_cmp(a, b):
        if not (torch.equal(a.cursor, b.offs + b.hist)
                and torch.equal(queue_sorted(a), queue_sorted(b))):
            raise AssertionError(f"{label}: scatter differs")

    binned = run("scatter", s2.scatter_by_leaf, s2.bin_by_leaf_plain,
                 planned, 4 * (n + 2 * n_fat + live), scatter_cmp)
    parts["scatter"]["ops"] = live
    tiles = int(binned.info[1])

    # the leaf test: both instances against the plain step, on the same
    # (kernel-binned) queue
    keep = torch.zeros(binned.max_tiles * 128, 4, dtype=torch.int32,
                       device=r.origin.device)

    def same_best(a, b, what):
        if not (torch.equal(a.bt, b.bt) and torch.equal(a.bc, b.bc)):
            raise AssertionError(f"{label}: {what} leaf test differs")

    pos, f_all = s2.queue_positions(binned)
    touched = torch.unique(f_all)
    fs = tables["fat_start"].long()
    leaf_bytes = (pos.numel() * (4 + 64 + 8 + 8)
                  + 80 * int((fs[touched + 1] - fs[touched]).sum()))
    tested = run("leaf_tf32",
                 lambda st: s2.leaf_test(st, tables, "tf32", keep),
                 lambda st: s2.leaf_test_plain(st, tables), binned,
                 leaf_bytes, lambda a, b: same_best(a, b, "tf32"))
    run("leaf_fp32", lambda st: s2.leaf_test(st, tables, "fp32"),
        lambda st: s2.leaf_test_plain(st, tables), binned,
        leaf_bytes, lambda a, b: same_best(a, b, "fp32"))

    # the prefilter: its survivors against the plain filter's, and every
    # pair the exact test accepts under the tile's starting best t kept
    width = s2._width(tables)
    col = torch.arange(width, device=pos.device)
    count = dict(pairs=0, kept=0, exact=0, missed=0, agree=0)
    for k in range(0, pos.numel(), 1 << 16):
        e = pos[k:k + (1 << 16)]
        rr = binned.queue[e].long()
        f = f_all[k:k + (1 << 16)]
        kept = ((keep[e][:, col // 32] >> (col % 32)) & 1).bool()
        row, bt = binned.ray[rr], binned.bt[rr]
        plain_keep = s2.tf32_filter_plain(tables, f, row, bt, width)
        ok, t, _ = s2.slot_pass(tables, f, row[:, 3:6].unbind(-1),
                                row[:, 9:12].unbind(-1),
                                row[:, 12:15].unbind(-1), width)
        need = ok & (t <= bt[:, None])
        valid = col < (fs[f + 1] - fs[f])[:, None]
        count["pairs"] += int(valid.sum())
        count["kept"] += int(kept.sum())
        count["exact"] += int(need.sum())
        count["missed"] += int((need & ~kept).sum()
                               + (need & ~plain_keep).sum())
        count["agree"] += int(((kept == plain_keep) & valid).sum())
    if count["missed"]:
        raise AssertionError(f"{label}: the prefilter rejected pairs the "
                             f"exact test accepts: {count}")
    filt = dict(pairs=count["pairs"],
                pass_share=count["kept"] / count["pairs"],
                exact_share=count["exact"] / count["pairs"],
                agreement_with_plain=count["agree"] / count["pairs"])
    if filt["agreement_with_plain"] < 0.999:
        raise AssertionError(f"{label}: the prefilter disagrees with its "
                             f"plain version: {filt}")
    del keep

    rewalked = run("walk2", lambda st: s2.walk_to_leaf(st, tables, any_hit),
                   lambda st: s2.walk_to_leaf_plain(st, tables, any_hit),
                   tested, n * (64 + 20 + 16),
                   lambda a, b: same_state(a, b, f"{label} second walk"))

    outs = {}

    def tail_kernel(st):
        outs["kernel"] = kernels.hit_outputs(r.origin)
        s2.stream2_tail(st, tables, any_hit, outs["kernel"])

    def tail_plain(st):
        outs["plain"] = kernels.hit_outputs(r.origin)
        steps.tail(st, outs["plain"])

    run("tail", tail_kernel, tail_plain, rewalked, n * (64 + 20 + 16),
        lambda a, b: compare_hits(outs["kernel"], outs["plain"],
                                  f"{label} tail"))
    WORK.clear()
    return parts, dict(filt, live_after_walk=live, tiles=tiles)


def stream2_variant(c, data, instance=None, tail_min=None, steps=None,
                    per_thread=False):
    """Cast ``c`` through the queued fat-leaf traversal with a leaf-test
    instance, tail size or steps class of its own (the A/Bs), or through
    the per-thread kernel whole.  Returns (outputs, dict(rounds, tail_rays)
    or None)."""
    from clive2_tpu_torch.ops import traverse_stream2 as s2

    rays, tables, out = s2.kernel_args(c["origin"], c["direction"], data,
                                       c["active"], c["t_max"])
    if per_thread:
        s2.stream2_thread(rays, tables, c["any_hit"], out)
        return out, None
    stats = s2.queued_cast(
        (rays.origin, rays.direction, rays.active, rays.t_max),
        (steps or s2.KernelSteps)(tables, c["any_hit"],
                                  instance or s2.LEAF_TEST), out,
        tail_min=s2.TAIL_MIN if tail_min is None else tail_min)
    return out, dict(zip(("rounds", "tail_rays"), stats))


def stream2_breakdown(c, data):
    """Where one queued fat-leaf cast's time goes: CUDA events around each
    step (walk; the binning's count, plan and scatter kernels; leaf test;
    tail, which runs on a side stream beside the next chunk's rounds),
    summed by step and by round over the chunks, beside the host clock
    around the whole cast."""
    import torch

    from clive2_tpu_torch.ops import traverse_stream2 as s2

    events, rounds = [], [0]

    def timed(name, fn, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        events.append((name, rounds[0], a, b))
        return out

    class Timed(s2.KernelSteps):
        def walk(self, st, rays=None):
            rounds[0] = 0 if rays is not None else rounds[0] + 1
            timed("walk", super().walk, st, rays)

        def bin(self, st):
            timed("count", s2.count_by_leaf, st)
            timed("plan", s2.plan_tiles, st)
            timed("scatter", s2.scatter_by_leaf, st)
            return self.read_info(st)

        def leaf_test(self, st):
            timed("leaf_test", super().leaf_test, st)

        def tail(self, st, out):
            # on the side stream the tail runs on, after what it waits for
            side = self.side_stream(st.ray.device)
            side.wait_stream(torch.cuda.current_stream(st.ray.device))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(side)
            super().tail(st, out)
            b.record(side)
            events.append(("tail_on_side_stream", rounds[0], a, b))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = stream2_variant(c, data, steps=Timed)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    ms, calls, by_round = {}, {}, {}
    for name, r, a, b in events:
        t = a.elapsed_time(b)
        ms[name] = ms.get(name, 0.0) + t
        calls[name] = calls.get(name, 0) + 1
        if name != "tail_on_side_stream":
            by_round[r] = by_round.get(r, 0.0) + t
    return dict(wall_ms=wall, steps_ms=ms, calls=calls,
                main_stream_ms_by_round=by_round,
                main_stream_idle_ms=wall - sum(by_round.values()),
                **stats)


def main() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels, rng
    from clive2_tpu_torch.integrator.trace import generate_camera_rays
    from clive2_tpu_torch.ops import (brute, intersect, traverse_bvh2,
                                      traverse_stream, traverse_stream2,
                                      traverse_wide)
    from clive2_tpu_torch.ops.intersect import WORK
    from clive2_tpu_torch.scene import PACKERS
    from clive2_tpu_torch.testing import tie_soup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, smi=smi)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so, nvcc_s = kernels.build()
    kernels.load()
    emit(phase="build", library=os.path.relpath(so),
         sources=[os.path.relpath(src) for src in kernels.sources()],
         nvcc_seconds=nvcc_s, seconds=time.perf_counter() - t0)
    # the persistent traversal kernels' and the brute kernel's resources:
    # ptxas's report (registers, shared memory, spills), what the runtime
    # reports (resident blocks), and their SASS instruction counts
    for name, src, module in (("bvh2", "traverse_bvh2.cu", traverse_bvh2),
                              ("stream", "traverse_stream.cu",
                               traverse_stream),
                              ("wide", "traverse_wide.cu", traverse_wide),
                              ("brute", "brute.cu", None)):
        ptxas = kernels.ptxas_report(src)
        emit(phase=f"{name}_resources",
             ptxas=[ln.strip() for ln in ptxas.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln],
             runtime=None if module is None else {
                 "any_hit" if a else "closest": module.kernel_info(any_hit=a)
                 for a in (False, True)})
    emit(phase="sass", library=os.path.relpath(so), kernels=sass_figures(so))

    gen = torch.Generator(device=dev).manual_seed(1234)
    modules = dict(bvh2=traverse_bvh2, stream2=traverse_stream2,
                   wide=traverse_wide, stream=traverse_stream)
    # every kernel's wrapper, by the name its launch count goes under
    wrappers = dict(brute=brute.intersect_brute, **{
        name: getattr(module, f"intersect_{name}")
        for name, module in modules.items()})
    # the errors by kernel; a fat-leaf cast under QUEUE_MIN rays takes the
    # per-thread kernel (stream2_thread), a larger one the queued kernels
    err = dict.fromkeys([*wrappers, "stream2_thread"], 0.0)

    def err_key(name, c):
        small = c["origin"].shape[0] < traverse_stream2.QUEUE_MIN
        return "stream2_thread" if name == "stream2" and small else name

    # ---- 3. brute kernel vs plain ----------------------------------------
    cornell = ct.create_scene_from_preset("empty", 1920, 1080, device=dev)
    soup_c = torch.rand(256, 1, 3, generator=gen, device=dev) * 16 - 8
    soup = soup_c + torch.rand(256, 3, 3, generator=gen, device=dev) - 0.5
    soup_tris = torch.zeros(256, 10, device=dev)
    soup_tris[:, 0:3] = soup[:, 0]
    soup_tris[:, 3:6] = soup[:, 1] - soup[:, 0]
    soup_tris[:, 6:9] = soup[:, 2] - soup[:, 0]
    cam_o = generate_camera_rays(rng.key(7, dev), cornell.data["camera"],
                                 1920, 1080)[0]
    ray_sets = {
        "random": random_rays(1 << 20, -10.0, 10.0, gen, dev),
        "camera": (cam_o["origin"], cam_o["direction"]),
    }
    # the hand-built edges of the test (and of the pre-test), each against
    # both edge triangles
    from clive2_tpu_torch.testing import brute_edge_cases

    eo, ed, etris = (torch.from_numpy(x).to(dev) for x in brute_edge_cases())
    for k in range(etris.shape[0]):
        got = brute.intersect_brute(eo, ed, etris[k:k + 1])
        compare_hits(got, brute.brute_plain(eo, ed, etris[k:k + 1]),
                     f"brute pre-test edges, triangle {k}")
    checks = 2
    for tname, tris in (("cornell", cornell.data["brute"]["tris"]),
                        ("soup256", soup_tris)):
        for rname, (o, d) in ray_sets.items():
            n = o.shape[0]
            active = torch.rand(n, generator=gen, device=dev) < 0.7
            t_max = torch.rand(n, generator=gen, device=dev) * 30
            for variant, kw in (("plain", {}),
                                ("masked", dict(active=active, t_max=t_max))):
                got = brute.intersect_brute(o, d, tris, **kw)
                want = brute.brute_plain(o, d, tris, **kw)
                e = compare_hits(got, want, f"brute {tname} {rname} {variant}")
                err["brute"] = max(err["brute"], e)
                checks += 1
    torch.cuda.synchronize()
    emit(phase="kernel_brute_vs_plain", checks=checks,
         edge_rays=eo.shape[0], max_abs_err_t=err["brute"], ids_equal=True)

    # ---- 4. BVH2 kernel vs the plain gather walk --------------------------
    from clive2_tpu_torch.load import write_obj
    from clive2_tpu_torch.models import utah_teapot
    from clive2_tpu_torch.scene import RESOURCE_DIR

    teapot = os.path.join(RESOURCE_DIR, "teapot.obj")
    if not os.path.exists(teapot):
        os.makedirs(RESOURCE_DIR, exist_ok=True)
        v, f = utah_teapot(n=10)
        write_obj(teapot, v, f)
    t0 = time.perf_counter()
    teapots = ct.create_scene_from_preset("teapots", 512, 512, device=dev)
    build_s = time.perf_counter() - t0
    cam_t = generate_camera_rays(rng.key(8, dev), teapots.data["camera"],
                                 512, 512)[0]
    lo = teapots.data["bvh"]["node_packed"][0, 0:3]
    hi = teapots.data["bvh"]["node_packed"][0, 3:6]
    sets = {
        "coherent": (cam_t["origin"], cam_t["direction"]),
        "incoherent": random_rays(1 << 18, lo, hi, gen, dev),
    }
    # each set: closest-hit, and any-hit under a finite cap (visibility
    # casts)
    checks = 0
    for rname, (o, d) in sets.items():
        n = o.shape[0]
        active = torch.rand(n, generator=gen, device=dev) < 0.8
        t_max = torch.rand(n, generator=gen, device=dev) * 12
        want = intersect.intersect_bvh_packed(o, d, teapots.data["bvh"],
                                              active=active)
        want_any = intersect.intersect_bvh_packed(
            o, d, teapots.data["bvh"], active=active, t_max=t_max)
        got = traverse_bvh2.intersect_bvh2(o, d, teapots.data, active=active)
        e = compare_hits(got, want, f"bvh2 {rname} closest")
        err["bvh2"] = max(err["bvh2"], e)
        got = traverse_bvh2.intersect_bvh2(o, d, teapots.data, active=active,
                                           t_max=t_max, any_hit=True)
        compare_hits(got, want_any, f"bvh2 {rname} any-hit", closest=False)
        checks += 2
    # the tie soup: 5,000 triangles twice, ids swapped in half the pairs;
    # every hit an exact tie, won by the lower slot.  The BVH2 kernel here,
    # the BVH8 and streaming kernels in phase 4b, on the same rays.
    rows, lower = tie_soup(9, 5000)
    ties = dict(bvh={k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
                **{name: {k: torch.from_numpy(v).to(dev) for k, v in
                          pack(rows["node_packed"],
                               rows["leaf_packed"]).items()}
                   for name, pack in (("bvh2", traverse_bvh2.pack_bvh2),
                                      ("wide", traverse_wide.pack_bvh8),
                                      ("stream",
                                       traverse_stream.pack_stream))})
    o, _ = random_rays(1 << 18, -8.0, 8.0, gen, dev)
    aim = torch.rand(1 << 18, 3, generator=gen, device=dev) * 10 - 5 - o
    tie_rays = (o, aim / aim.norm(dim=1, keepdim=True))
    tie_want = intersect.intersect_bvh_packed(*tie_rays, ties["bvh"])
    tie_hits = int((tie_want[0] >= 0).sum())

    def tie_check(got, label):
        e = compare_hits(got, tie_want, f"{label} tie soup")
        ids = got[0][got[0] >= 0].cpu().numpy()
        if not (ids == lower(ids)).all():
            raise AssertionError(f"{label} tie soup: a tie went to the "
                                 "higher slot")
        return e

    err["bvh2"] = max(err["bvh2"], tie_check(
        traverse_bvh2.intersect_bvh2(*tie_rays, ties), "bvh2"))
    checks += 1
    if tie_hits < 10_000:
        raise AssertionError(f"tie soup: only {tie_hits} hits")
    torch.cuda.synchronize()
    emit(phase="kernel_bvh2_vs_plain", checks=checks, scene_tris=
         teapots.n_triangles, scene_build_s=build_s,
         tie_soup=dict(tris=10_000, rays=1 << 18, hits=tie_hits,
                       lower_slot_wins=True),
         bvh2_table_bytes=table_bytes(teapots.data["bvh2"]),
         max_abs_err_t=err["bvh2"], ids_equal=True, any_hit_verdicts_equal=True)
    del rows, o, aim, want, want_any, got

    # ---- 4b. the traversal kernels of the large and A/B paths vs plain ----
    # Each kernel against its plain version on 512^2 camera rays and 2^18
    # random rays inside the scene's root box, 80% of them active:
    # closest-hit, closest-hit under random caps, and any-hit under them.
    # The scenes come through create_scene_from_preset, with the JAX
    # package's selectors set for the wide and stream1 scenes.
    from clive2_tpu_torch.bvh import native

    assets = write_assets(RESOURCE_DIR)
    dragon, build_s, bvh_s = build_timed("medium-dragon", 512, 512, dev)
    s2_tables = dragon.data["stream2"]
    emit(phase="assets", written_s=assets,
         native_bvh=native.available(),
         scene="medium-dragon", scene_tris=dragon.n_triangles,
         scene_build_s=build_s, bvh_build_s=bvh_s,
         fat_leaves=s2_tables["fat_start"].numel() - 1,
         top_nodes=s2_tables["childs"].shape[0])
    with environment(CLIVE2_TRAVERSAL="wide"):
        dragon_w, build_s, bvh_s = build_timed("dragon", 512, 512, dev)
    emit(phase="scene", name="dragon", selector="CLIVE2_TRAVERSAL=wide",
         scene_tris=dragon_w.n_triangles, scene_build_s=build_s,
         bvh_build_s=bvh_s, wide_nodes=dragon_w.data["wide"]["nodes"].shape[0],
         wide_table_bytes={k: table_bytes({k: v}) for k, v in
                           dragon_w.data["wide"].items()
                           if k not in ("lo", "hi")})
    with environment(CLIVE2_STREAM_IMPL="1"):
        dragon_s1, build_s, bvh_s = build_timed("medium-dragon", 512, 512,
                                                dev)
    emit(phase="scene", name="medium-dragon", selector="CLIVE2_STREAM_IMPL=1",
         scene_tris=dragon_s1.n_triangles, scene_build_s=build_s,
         bvh_build_s=bvh_s,
         sub_leaves=dragon_s1.data["stream"]["subs"].shape[0],
         stream_table_bytes={k: table_bytes({k: v}) for k, v in
                             dragon_s1.data["stream"].items()
                             if k not in ("lo", "hi")})
    for scene, want in ((dragon, "stream2"), (dragon_w, "wide"),
                        (dragon_s1, "stream")):
        got = sorted(set(scene.data) & set(PACKERS))
        if got != [want]:
            raise AssertionError(f"expected the {want} tables, got {got}")

    plains = {
        "stream2": lambda c, data: traverse_stream2.stream2_plain(
            c["origin"], c["direction"], data["stream2"],
            active=c["active"], t_max=c["t_max"], any_hit=c["any_hit"]),
        "wide": lambda c, data: traverse_wide.wide_plain(
            c["origin"], c["direction"], data["wide"],
            active=c["active"], t_max=c["t_max"], any_hit=c["any_hit"]),
        "stream": lambda c, data: traverse_stream.stream_plain(
            c["origin"], c["direction"], data["stream"],
            active=c["active"], t_max=c["t_max"], any_hit=c["any_hit"]),
    }

    def launch(name, c, data):
        return wrappers[name](c["origin"], c["direction"], data,
                              active=c["active"], t_max=c["t_max"],
                              any_hit=c["any_hit"])

    for name, scene, key in (("stream2", dragon, 9), ("wide", dragon_w, 10),
                             ("stream", dragon_s1, 11)):
        cam = generate_camera_rays(rng.key(key, dev), scene.data["camera"],
                                   512, 512)[0]
        lo = scene.data["bvh"]["node_packed"][0, 0:3]
        hi = scene.data["bvh"]["node_packed"][0, 3:6]
        sets = {"coherent": (cam["origin"], cam["direction"]),
                "incoherent": random_rays(1 << 18, lo, hi, gen, dev)}
        checks, hits, any_ids_equal = 0, {}, True
        for rname, (o, d) in sets.items():
            n = o.shape[0]
            active = torch.rand(n, generator=gen, device=dev) < 0.8
            t_max = torch.rand(n, generator=gen, device=dev) * 12
            for variant, cap, any_hit in (("closest", None, False),
                                          ("capped", t_max, False),
                                          ("any-hit", t_max, True)):
                c = dict(origin=o, direction=d, active=active, t_max=cap,
                         any_hit=any_hit)
                got = launch(name, c, scene.data)
                want = plains[name](c, scene.data)
                e = compare_hits(got, want, f"{name} {rname} {variant}",
                                 closest=not any_hit)
                err[err_key(name, c)] = max(err[err_key(name, c)], e)
                any_ids_equal &= bool(torch.equal(got[0], want[0]))
                hits[f"{rname} {variant}"] = int((want[0] >= 0).sum())
                checks += 1
        if name in ("wide", "stream"):
            # the tie soup of phase 4, on the kernel's own tables
            err[name] = max(err[name], tie_check(
                wrappers[name](*tie_rays, ties), name))
            checks += 1
        torch.cuda.synchronize()
        emit(phase=f"kernel_{name}_vs_plain", scene_tris=scene.n_triangles,
             checks=checks, hits=hits,
             max_abs_err_t=err[err_key(name, c)],
             ids_equal=True, any_hit_verdicts_equal=True,
             any_hit_ids_equal=any_ids_equal)
        del sets, cam, got, want
    del ties, tie_rays, tie_want

    # ---- 5. the kernels on the main path's own casts ----------------------
    # One sample of each configuration runs with its kernel's wrapper
    # recording the first cast of each shape it is given: the merged
    # camera+light extension cast (2N rays) and the any-hit connection cast
    # (36N rays).  Each recorded cast then runs through the kernel and its
    # plain version, timed with CUDA events, and the outputs are compared.
    def brute_cast(fn):
        tris = cornell.data["brute"]["tris"]
        return lambda c: fn(c["origin"], c["direction"], tris,
                            active=c["active"], t_max=c["t_max"])

    def bvh2_plain(c):
        return intersect.intersect_bvh_packed(
            c["origin"], c["direction"], teapots.data["bvh"],
            active=c["active"], t_max=c["t_max"])

    timing, bounds, compared, pretest_of = {}, {}, {}, {}
    for name, scene, w, h, module, wrapper, kernel_fn, plain_fn, tables in (
            ("brute", cornell, 1920, 1080, brute, "intersect_brute",
             brute_cast(brute.intersect_brute), brute_cast(brute.brute_plain),
             cornell.data["brute"]),
            ("bvh2", teapots, 512, 512, traverse_bvh2, "intersect_bvh2",
             lambda c: launch("bvh2", c, teapots.data), bvh2_plain,
             {k: teapots.data["bvh2"][k] for k in ("nodes", "tris")})):
        casts = record_casts(module, wrapper, ct.Renderer(scene, seed=1,
                                                          device=dev))
        n = w * h
        shapes = {2 * n: "extension", 36 * n: "connection"}
        if sorted(casts) != sorted(shapes):
            raise AssertionError(f"{name}: casts of {sorted(casts)} rays, "
                                 f"expected {sorted(shapes)}")
        for rays, c in sorted(casts.items()):
            ms, got = cuda_time(lambda: kernel_fn(c), 5)
            plain_ms, want, work = plain_time(lambda: plain_fn(c))
            label = f"{name} {shapes[rays]} cast"
            e = compare_hits(got, want, label, closest=not c["any_hit"])
            err[name] = max(err[name], e)
            timing[name, shapes[rays]] = (ms, plain_ms)
            compared[name, shapes[rays]] = rays
            bounds[name, shapes[rays]] = bound(cast_bytes(c, tables),
                                               work_ops(work))
            extra = {}
            if name == "brute":
                # where an exact pre-test would end the tests, and a --fmad=true
                # build timed beside the kernel (kernel, fmad, kernel)
                tris = cornell.data["brute"]["tris"]
                extra["pretest"] = brute_pretest(c, tris)
                extra["fmad_true"] = brute_fmad(c, tris, got)
                extra["ms_again"] = cuda_time(lambda: kernel_fn(c), 5)[0]
                pretest_of[shapes[rays]] = extra["pretest"]
            emit(phase="main_path_cast", kernel=name, cast=shapes[rays],
                 rays=rays, any_hit=c["any_hit"],
                 active=rays if c["active"] is None else int(c["active"].sum()),
                 capped=c["t_max"] is not None, ms=ms, plain_ms=plain_ms,
                 mrays_s=rays / ms / 1e3, plain_mrays_s=rays / plain_ms / 1e3,
                 bound_ms=bounds[name, shapes[rays]][0],
                 bound_by=bounds[name, shapes[rays]][1],
                 bound_share=bounds[name, shapes[rays]][0] / ms, work=work,
                 max_abs_err_t=e, matches_plain=True, **extra)
            del got, want
        del casts, c
    torch.cuda.empty_cache()

    # ---- 5b. the traversal kernels on the BVH scenes' own casts ----------
    # One sample of each scene runs with its kernel's wrapper recording its
    # casts.  The kernel is timed over 5 launches on each whole cast, and
    # the output of that full-size launch is held against the plain walk
    # (one host sync per step, run once) on every k-th ray, k the least
    # stride that leaves at most 2^20 rays.  The other kernels that can
    # carry the scene (the default's, with tables packed from the same
    # gather-walk rows) are timed on the whole cast as an A/B, with their
    # agreement with the kernel.
    sponza, build_s, bvh_s = build_timed("sponza", 1920, 1080, dev)
    emit(phase="scene", name="sponza", scene_tris=sponza.n_triangles,
         scene_build_s=build_s, bvh_build_s=bvh_s,
         fat_leaves=sponza.data["stream2"]["fat_start"].numel() - 1,
         top_nodes=sponza.data["stream2"]["childs"].shape[0])
    t0 = time.perf_counter()
    sponza_s1 = with_traversal(sponza, "stream")
    emit(phase="scene", name="sponza", selector="traversal='stream'",
         pack_s=time.perf_counter() - t0,
         sub_leaves=sponza_s1.data["stream"]["subs"].shape[0],
         stream_table_bytes={k: table_bytes({k: v}) for k, v in
                             sponza_s1.data["stream"].items()
                             if k not in ("lo", "hi")},
         gather_walk_bytes=table_bytes(sponza.data["bvh"]))
    ab_scenes = {"medium_dragon": with_traversal(dragon, "bvh2"),
                 "sponza": with_traversal(sponza, "bvh2"),
                 "dragon": with_traversal(dragon_w, "bvh2")}
    for sname, ab_scene in ab_scenes.items():
        emit(phase="bvh2_tables", scene=sname,
             scene_tris=ab_scene.n_triangles,
             bvh2_table_bytes=table_bytes(ab_scene.data["bvh2"]))
    s2 = traverse_stream2
    parts_of, bvh2_casts = {}, set()
    for name, sname, scene, w, h, ab in (
            ("stream2", "medium_dragon", dragon, 512, 512,
             dict(bvh2=ab_scenes["medium_dragon"], stream=dragon_s1)),
            ("stream2", "sponza", sponza, 1920, 1080,
             dict(bvh2=ab_scenes["sponza"], stream=sponza_s1)),
            ("wide", "dragon", dragon_w, 512, 512,
             dict(bvh2=ab_scenes["dragon"])),
            ("stream", "medium_dragon", dragon_s1, 512, 512,
             dict(stream2=dragon, bvh2=ab_scenes["medium_dragon"])),
            ("stream", "sponza", sponza_s1, 1920, 1080,
             dict(stream2=sponza, bvh2=ab_scenes["sponza"]))):
        casts = record_casts(modules[name], f"intersect_{name}",
                             ct.Renderer(scene, seed=1, device=dev))
        n = w * h
        shapes = {2 * n: "extension", 36 * n: "connection"}
        if sorted(casts) != sorted(shapes):
            raise AssertionError(f"{name} {sname}: casts of {sorted(casts)} "
                                 f"rays, expected {sorted(shapes)}")
        for rays, c in sorted(casts.items()):
            ms, got = cuda_time(lambda: launch(name, c, scene.data), 5)
            last = s2.intersect_stream2.last if name == "stream2" else None
            stride = -(-rays // (1 << 20))
            part = strided(c, stride)
            plain_ms, want, work = plain_time(
                lambda: plains[name](part, scene.data))
            got_part = tuple(x[::stride] for x in got)
            m = part["origin"].shape[0]
            label = f"{name} {sname} {shapes[rays]} cast"
            e = compare_hits(got_part, want, label, closest=not c["any_hit"])
            err[err_key(name, c)] = max(err[err_key(name, c)], e)
            timing[name, sname, shapes[rays]] = (ms, plain_ms)
            compared[name, sname, shapes[rays]] = m
            bounds[name, sname, shapes[rays]] = bound(
                cast_bytes(c, scene.data[name]), work_ops(work, stride))

            def same_as(out):
                return ((out[0] >= 0) == (got[0] >= 0) if c["any_hit"]
                        else out[0] == got[0])

            abs_ = {}
            for ab_name, ab_scene in ab.items():
                ab_ms, ab_out = cuda_time(
                    lambda: launch(ab_name, c, ab_scene.data), 5)
                abs_[ab_name] = dict(
                    ms=ab_ms, mrays_s=rays / ab_ms / 1e3,
                    agreement=float(same_as(ab_out).float().mean()))
                key = (sname, shapes[rays])
                if ab_name == "bvh2" and key not in bvh2_casts:
                    # once per scene and cast: the BVH2 kernel against the
                    # gather walk on the same strided rays
                    bvh2_casts.add(key)
                    want_b = intersect.intersect_bvh_packed(
                        part["origin"], part["direction"],
                        ab_scene.data["bvh"], active=part["active"],
                        t_max=part["t_max"])
                    e_b = compare_hits(tuple(x[::stride] for x in ab_out),
                                       want_b, f"{label} on bvh2",
                                       closest=not c["any_hit"])
                    err["bvh2"] = max(err["bvh2"], e_b)
                    emit(phase="bvh2_ab_cast", scene=sname,
                         cast=shapes[rays], rays=rays, any_hit=c["any_hit"],
                         ms=ab_ms, mrays_s=rays / ab_ms / 1e3,
                         compared_rays=m, compared_stride=stride,
                         max_abs_err_t=e_b, matches_plain=True)
                    del want_b
                del ab_out
            if name == "stream2":
                # the per-thread kernel, the other leaf-test instance, and
                # other tail sizes, on the same cast: all equal the
                # default's ids
                other = "tf32" if s2.LEAF_TEST == "fp32" else "fp32"
                for key, kw in (("per_thread", dict(per_thread=True)),
                                (f"{other}_leaf_test", dict(instance=other)),
                                *((f"tail_min_{t}", dict(tail_min=t))
                                  for t in (0, 1 << 12, 1 << 14, 1 << 18))):
                    v_ms, (v_out, stats) = cuda_time(
                        lambda: stream2_variant(c, scene.data, **kw), 5)
                    ids = float((v_out[0] == got[0]).float().mean())
                    if ids != 1.0:
                        raise AssertionError(f"{label}: {key} ids agree on "
                                             f"{ids} of the rays")
                    if key == "per_thread":
                        # the per-thread kernel's own error against the
                        # plain walk: t on every compared hit with the same
                        # id, on any-hit casts too
                        v_part = tuple(x[::stride] for x in v_out)
                        compare_hits(v_part, want, f"{label} per-thread",
                                     closest=not c["any_hit"])
                        hit = (want[0] >= 0) & (v_part[0] == want[0])
                        e_t = float((v_part[1][hit] - want[1][hit]).abs()
                                    .max()) if hit.any() else 0.0
                        err["stream2_thread"] = max(err["stream2_thread"],
                                                    e_t)
                        del v_part
                    timing[name, sname, f"{shapes[rays]} {key}"] = v_ms
                    abs_[key] = dict(ms=v_ms, mrays_s=rays / v_ms / 1e3,
                                     ids_agreement=ids, **(stats or {}))
                    del v_out
                emit(phase="stream2_breakdown", scene=sname,
                     cast=shapes[rays], rays=rays,
                     **stream2_breakdown(c, scene.data))
                # one round, kernel by kernel, on the cast's first chunk:
                # the shapes the main path's first launches get
                head = {k: v if k == "any_hit" or v is None
                        else v[:s2.CHUNK] for k, v in c.items()}
                parts, filt = stream2_parts(head, scene.data["stream2"],
                                            label)
                parts_of[sname, shapes[rays]] = parts
                emit(phase="kernel_stream2_parts_vs_plain", scene=sname,
                     cast=shapes[rays], rays=rays,
                     chunk_rays=head["origin"].shape[0],
                     parts={k: dict(v, bound_ms=bound(v["bytes"],
                                                      v["ops"])[0])
                            for k, v in parts.items()},
                     prefilter=filt, equal=True)
            cap = c["t_max"]
            emit(phase="main_path_cast", kernel=name, scene=sname,
                 cast=shapes[rays], rays=rays, compared_rays=m,
                 compared_stride=stride, any_hit=c["any_hit"],
                 active=rays if c["active"] is None
                 else int(c["active"].sum()),
                 capped=cap is not None,
                 cap_finite_share=None if cap is None
                 else float(torch.isfinite(cap).float().mean()),
                 cap_max_finite=None if cap is None
                 else float(cap[torch.isfinite(cap)].max()),
                 ms=ms, mrays_s=rays / ms / 1e3, plain_ms=plain_ms,
                 plain_mrays_s=m / plain_ms / 1e3,
                 bound_ms=bounds[name, sname, shapes[rays]][0],
                 bound_by=bounds[name, sname, shapes[rays]][1],
                 bound_share=bounds[name, sname, shapes[rays]][0] / ms,
                 work=work, work_stride=stride,
                 rounds=last and last["rounds"],
                 tail_share=last and last["tail_rays"] / rays, ab=abs_,
                 max_abs_err_t=e, matches_plain=True,
                 any_hit_ids_equal=bool(torch.equal(got_part[0], want[0])))
            del got, got_part, want, part
        del casts, c
        torch.cuda.empty_cache()

    # ---- 6./7. the main path at full size ----------------------------------
    # the queued fat-leaf traversal's kernels, counted apart from its casts
    # (intersect_stream2.launches counts casts)
    # every launch count, plain versions' calls included (testing.py)
    from clive2_tpu_torch.integrator.render import _wave_order as wave_order
    from clive2_tpu_torch.testing import check_launches, launch_counters

    queued = ("stream2", "stream2_walk", "stream2_count", "stream2_plan",
              "stream2_scatter", "stream2_leaf", "stream2_tail")
    counters = launch_counters()

    # the two large default slices are each followed by their A/B: the same
    # render on the BVH2 kernel's tables, whose launches stay out of the
    # main path's counts; the medium dragon's extension casts (524,288 rays)
    # are under QUEUE_MIN and take the per-thread fat-leaf kernel
    slices, launches = {}, dict.fromkeys(counters, 0)
    for name, scene, w, h, kernel in (
            ("cornell_1080p", cornell, 1920, 1080, ("brute",)),
            ("teapots_512", teapots, 512, 512, ("bvh2",)),
            ("medium_dragon_512", dragon, 512, 512,
             queued + ("stream2_thread",)),
            ("medium_dragon_512_bvh2_ab", ab_scenes["medium_dragon"], 512,
             512, ("bvh2",)),
            ("sponza_1080p", sponza, 1920, 1080, queued),
            ("sponza_1080p_bvh2_ab", ab_scenes["sponza"], 1920, 1080,
             ("bvh2",)),
            ("dragon_512_wide", dragon_w, 512, 512, ("wide",)),
            ("medium_dragon_512_stream1", dragon_s1, 512, 512, ("stream",)),
            ("sponza_1080p_stream1", sponza_s1, 1920, 1080, ("stream",))):
        ab = name.endswith("_ab")
        for fn, attr in counters.values():    # counted from 0 per path
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        r = ct.Renderer(scene, seed=0, device=dev)
        times, rays = [], 0
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.run_sample()
            r.block()
            times.append(time.perf_counter() - t0)
            rays += int(r.last_n_rays)
        ran = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        if not ab:
            launches = {k: launches[k] + ran[k] for k in counters}
        img = r.raw_image
        slices[name] = dict(
            phase="slice_ab" if ab else "slice", name=name, width=w,
            height=h, order=wave_order(scene.data), spp=2,
            s_per_sample=times,
            mrays_s=rays / sum(times) / 1e6, rays=rays, counts=ran,
            image_mean=float(img.mean()),
            finite=bool(np.isfinite(img).all()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            scene_tris=scene.n_triangles)
        emit(**slices[name])
        check_launches(name, kernel, ran)
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite image")
        if not img.mean() > 0:
            raise AssertionError(f"{name}: the image is black")
        del r, img

    # ---- 7b. the reference estimator, the oracles, adaptive samples and
    # stripes: each path driven through the renderer with every launch
    # count set to 0 just before it and read just after, then its new casts
    # held to their plain versions
    from clive2_tpu_torch import constants, oracles

    def drive(label, kernel, run):
        """``run()`` with the launch counts from 0; fails when a kernel of
        ``kernel`` never ran, a plain version ran, or another kernel ran.
        Returns the counts."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        run()
        torch.cuda.synchronize()
        ran = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        check_launches(label, kernel, ran)
        return {k: v for k, v in ran.items() if v}

    def samples(r, n, adaptive=None):
        """Host seconds of each of ``n`` samples of ``r`` (adaptive ones at
        fraction ``adaptive``), each ended by a synchronise."""
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if adaptive is None:
                r.run_sample()
            else:
                r.run_adaptive_sample(adaptive)
            r.block()
            times.append(time.perf_counter() - t0)
        return times

    def image_ok(label, img):
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"{label}: non-finite or black image")

    def agree(a, b, rtol=1e-4, atol=1e-6):
        """Share of pixels whose image and weight agree, and the largest
        difference of each, between two states or two samples (tensors or
        arrays)."""
        def get(x, *names):
            v = next(x[k] for k in names if k in x)
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

        img = [get(x, "summed_image", "image") for x in (a, b)]
        wts = [get(x, "summed_weight", "weight") for x in (a, b)]
        close = np.isclose(*img, rtol=rtol, atol=atol).all(-1) & np.isclose(
            *wts, rtol=rtol, atol=atol)
        return dict(share=float(close.mean()), rtol=rtol, atol=atol,
                    image_max_abs=float(np.abs(img[0] - img[1]).max()),
                    weight_max_abs=float(np.abs(wts[0] - wts[1]).max()))

    extra_casts = {}
    constants.REFERENCE_MIS = True
    try:
        for name, scene, w, h, kernel, module, wrapper, kernel_fn, \
                plain_fn, tables in (
                ("cornell_1080p", cornell, 1920, 1080, "brute", brute,
                 "intersect_brute", brute_cast(brute.intersect_brute),
                 brute_cast(brute.brute_plain), cornell.data["brute"]),
                ("teapots_512", teapots, 512, 512, "bvh2", traverse_bvh2,
                 "intersect_bvh2", lambda c: launch("bvh2", c, teapots.data),
                 bvh2_plain, {k: teapots.data["bvh2"][k]
                              for k in ("nodes", "tris")})):
            r = ct.Renderer(scene, seed=0, device=dev)
            out = {}
            ran = drive(f"estimator_refmis {name}", (kernel,),
                        lambda: out.update(times=samples(r, 2)))
            img = r.raw_image
            image_ok(f"estimator_refmis {name}", img)
            # the verify skill's band for the reference estimator's Cornell
            # image at 16:9 (0.00854 measured on the card at 2 spp)
            if name == "cornell_1080p" and not 0.0079 <= img.mean() <= 0.0092:
                raise AssertionError(f"reference estimator: Cornell image "
                                     f"mean {img.mean()} outside the 16:9 "
                                     "band 0.0079-0.0092")
            casts = record_casts(module, wrapper,
                                 ct.Renderer(scene, seed=1, device=dev))
            c = casts[36 * w * h]
            if c["any_hit"] or c["t_max"] is None:
                raise AssertionError(f"{name}: the reference estimator's "
                                     "connection cast is not closest-hit "
                                     "and capped")
            held = held_cast(f"{kernel} refmis {name} connection", c,
                             kernel_fn, plain_fn, tables)
            err[kernel] = max(err[kernel], held["max_abs_err_t"])
            held["launches"] = ran[kernel] // 2   # per sample
            extra_casts[kernel, "refmis_connection"] = dict(
                held, cast=f"{name} connection, reference estimator")
            emit(phase="estimator_refmis", name=name, width=w, height=h,
                 spp=2, s_per_sample=out["times"], counts=ran,
                 image_mean=float(img.mean()), connection_cast=held)
            del r, img, casts, c
        imgs = {}
        for device in ("cpu", "cuda"):
            r = ct.Renderer(ct.create_scene_from_preset(
                "empty", 64, 64, device=device), seed=3)
            r.run_sample()
            imgs[device] = r.state["summed_image"].cpu().numpy()
        close = np.isclose(imgs["cuda"], imgs["cpu"], rtol=1e-3,
                           atol=1e-6).all(-1)
        emit(phase="estimator_refmis", name="cpu_vs_card", size=64, spp=1,
             pixels_close=float(close.mean()),
             image_mean=float(imgs["cuda"].mean()))
        if close.mean() < 0.99:
            raise AssertionError("reference estimator: card and CPU renders "
                                 "disagree")
    finally:
        constants.REFERENCE_MIS = False

    # the statistical oracles on the card (every scene on the brute kernel)
    numbers = {}

    def run_oracles():
        t0 = time.perf_counter()
        for name in ("convergence", "glass_convergence", "furnace",
                     "glass_furnace"):
            numbers[name] = getattr(oracles, name)(dev)
            numbers[name]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()

    ran = drive("oracles", ("brute",), run_oracles)
    emit(phase="oracles", counts=ran, **numbers)
    for name, r in numbers.items():
        oracles.check(name, r)

    # adaptive sampling: Cornell 1080p, 2 uniform then 2 adaptive samples
    w, h, frac = 1920, 1080, 0.25
    m = int(w * h * frac)
    r = ct.Renderer(cornell, seed=0, device=dev)
    out = {}
    ran = drive("adaptive", ("brute",), lambda: out.update(
        uniform=samples(r, 2), adaptive=samples(r, 2, adaptive=frac)))
    counts = r.state["pixel_count"]
    total = float(counts.sum())
    if total != 2 * w * h + 2 * m:
        raise AssertionError(f"adaptive: pixel_count sums to {total}, not "
                             f"{2 * w * h + 2 * m}")
    image_ok("adaptive", r.raw_image)
    casts = record_casts(brute, "intersect_brute", r,
                         run=lambda: r.run_adaptive_sample(frac))
    if sorted(casts) != [2 * m, 36 * m]:
        raise AssertionError(f"adaptive: casts of {sorted(casts)} rays")
    held = {}
    for rays, c in sorted(casts.items()):
        cast = "extension" if rays == 2 * m else "connection"
        held[cast] = held_cast(f"brute adaptive subset {cast}", c,
                               brute_cast(brute.intersect_brute),
                               brute_cast(brute.brute_plain),
                               cornell.data["brute"])
        err["brute"] = max(err["brute"], held[cast]["max_abs_err_t"])
    held["connection"]["launches"] = ran["brute"] // 4   # per sample
    extra_casts["brute", "adaptive_connection"] = dict(
        held["connection"], cast="cornell_1080p adaptive subset connection")
    emit(phase="adaptive", name="cornell_1080p", fraction=frac,
         selected=m, s_per_sample_uniform=out["uniform"],
         s_per_sample_adaptive=out["adaptive"], counts=ran,
         pixel_count_total=total,
         pixel_count_min=float(counts.min()),
         pixel_count_max=float(counts.max()),
         image_mean=float(r.raw_image.mean()), casts=held)
    del r, casts, counts

    # stripes: sponza 1080p full-frame and in 20 stripes of 54 rows, then
    # Cornell 3840x2160 in stripes of 270 rows (never full-frame)
    def peak(label, r, kernel):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        ran = drive(label, kernel, lambda: out.update(times=samples(r, 1)))
        image_ok(label, r.raw_image)
        return dict(s_per_sample=out["times"], counts=ran,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    peak_over_base_gib=(torch.cuda.max_memory_allocated()
                                        - base) / 2**30,
                    image_mean=float(r.raw_image.mean()))

    full = peak("chunked sponza full frame", ct.Renderer(
        sponza, seed=0, device=dev), queued)
    striped_r = ct.Renderer(sponza, seed=0, device=dev, chunk_rows=54)
    striped = peak("chunked sponza stripes", striped_r,
                   queued + ("stream2_thread",))
    casts = record_casts(traverse_stream2, "intersect_stream2", striped_r)
    n = 1920 * 54
    if sorted(casts) != [2 * n, 36 * n]:
        raise AssertionError(f"chunked: casts of {sorted(casts)} rays")
    held = {}
    for rays, c in sorted(casts.items()):
        cast = "extension" if rays == 2 * n else "connection"
        held[cast] = held_cast(
            f"stream2 sponza stripe {cast}", c,
            lambda c: launch("stream2", c, sponza.data),
            lambda c: plains["stream2"](c, sponza.data),
            sponza.data["stream2"], stride=-(-rays // (1 << 20)))
        key = err_key("stream2", c)
        err[key] = max(err[key], held[cast]["max_abs_err_t"])
    # per striped sample: the per-thread kernel's casts, and the casts that
    # took the queue (every cast of the sample, less the per-thread ones)
    held["extension"]["launches"] = striped["counts"]["stream2_thread"]
    held["connection"]["launches"] = (striped["counts"]["stream2"]
                                      - striped["counts"]["stream2_thread"])
    extra_casts["stream2_thread", "stripe_extension"] = dict(
        held["extension"], cast="sponza_1080p 54-row stripe extension")
    extra_casts["stream2", "stripe_connection"] = dict(
        held["connection"], cast="sponza_1080p 54-row stripe connection")
    del striped_r, casts
    torch.cuda.empty_cache()
    uhd = ct.create_scene_from_preset("empty", 3840, 2160, device=dev)
    uhd_run = peak("chunked cornell 4K", ct.Renderer(
        uhd, seed=0, device=dev, chunk_rows=270), ("brute",))
    emit(phase="chunked", sponza_1080p_full=full,
         sponza_1080p_chunk_rows_54=striped, stripe_casts=held,
         cornell_2160p_chunk_rows_270=uhd_run)
    del uhd
    torch.cuda.empty_cache()

    # ---- 7b'. the wave order ---------------------------------------------
    # The mesh cells under three orders, 2 samples each, seed 0: raster;
    # auto, the default (morton; the streaming tables' extension casts
    # still sorted per cast); morton with no per-cast sort.  Then each
    # kernel on its scene's depth-0, depth-3 and connection casts, recorded
    # unsorted in raster order and in the Morton wave order, the raster
    # ones also in Morton-key order (intersect_scene's sort), each timed
    # alone with CUDA events beside the sort's own steps (key, argsort,
    # the inputs' gathers, the outputs' inverse scatter).  Then the card's
    # busy share over one sample of teapots 512 and sponza 1080p in raster
    # and auto order (utils.profiling.trace_to), a CLIVE2_CONNECT_K=4
    # sample against K=0, and a morton render on the card against the CPU's.
    from clive2_tpu_torch.ops.intersect import morton_key, ray_order, unsort
    from clive2_tpu_torch.utils.profiling import device_busy, trace_to

    orders = {"raster": dict(CLIVE2_WAVE_ORDER="raster"),
              "auto": dict(CLIVE2_WAVE_ORDER="auto"),
              "morton_no_trace_sort": dict(CLIVE2_WAVE_ORDER="morton",
                                           CLIVE2_TRACE_SORT="0")}
    unsorted = dict(CLIVE2_TRACE_SORT="0", CLIVE2_CONNECT_SORT="0")
    cells = (("teapots_512", teapots, "bvh2", ("bvh2",)),
             ("dragon_512_wide", dragon_w, "wide", ("wide",)),
             ("medium_dragon_512", dragon, "stream2",
              queued + ("stream2_thread",)),
             ("sponza_1080p", sponza, "stream2", queued),
             ("sponza_1080p_stream1", sponza_s1, "stream", ("stream",)))
    cast_names = {0: "depth0", 3: "depth3", 6: "connection"}

    def sample_rays(r, n):
        """Host seconds and rays of each of ``n`` samples of ``r``."""
        times, rays = [], 0
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.run_sample()
            r.block()
            times.append(time.perf_counter() - t0)
            rays += int(r.last_n_rays)
        return times, rays

    def same_hits(a, b, any_hit, label):
        same = ((a[0] >= 0) == (b[0] >= 0)) if any_hit else (a[0] == b[0])
        if not bool(same.all()):
            raise AssertionError(f"{label}: sorted and unsorted casts "
                                 "disagree")

    def order_casts(label, c, table, scene):
        """One recorded cast timed as given and in Morton-key order, with
        the sort's steps."""
        tables = scene.data[table]
        ms, got = cuda_time(lambda: launch(table, c, scene.data), 5)
        key_ms, key = cuda_time(lambda: morton_key(
            c["origin"], c["direction"], tables["lo"], tables["hi"],
            c["active"]), 5)
        sort_ms, order = cuda_time(lambda: ray_order(key), 5)
        gather_ms, s = cuda_time(lambda: {
            k: v if k == "any_hit" or v is None else v[order]
            for k, v in c.items()}, 5)
        sorted_ms, out = cuda_time(lambda: launch(table, s, scene.data), 5)
        scatter_ms, back = cuda_time(lambda: unsort(order, out), 5)
        same_hits(back, got, c["any_hit"], label)
        glue = key_ms + sort_ms + gather_ms + scatter_ms
        del got, key, order, s, out, back
        return dict(ms=ms, key_order_ms=sorted_ms, glue_ms=dict(
            key=key_ms, argsort=sort_ms, gathers=gather_ms,
            inverse_scatter=scatter_ms, total=glue),
            key_order_with_glue_ms=sorted_ms + glue)

    wave = {}
    for name, scene, table, kernel in cells:
        w, h = scene.pixel_width, scene.pixel_height
        cell = dict(table=table, orders={}, casts={})
        for oname, env in orders.items():
            with environment(**env):
                r = ct.Renderer(scene, seed=0, device=dev)
                out = {}
                ran = drive(f"wave_order {name} {oname}", kernel, lambda: (
                    out.update(zip(("times", "rays"), sample_rays(r, 2)))))
                image_ok(f"wave_order {name} {oname}", r.raw_image)
                cell["orders"][oname] = dict(
                    order=wave_order(scene.data), s_per_sample=out["times"],
                    mrays_s=out["rays"] / sum(out["times"]) / 1e6,
                    rays=out["rays"], counts=ran,
                    image_mean=float(r.raw_image.mean()))
                del r
        for layout, env in (("raster", dict(CLIVE2_WAVE_ORDER="raster")),
                            ("wave", dict(CLIVE2_WAVE_ORDER="morton"))):
            with environment(**env, **unsorted):
                casts = record_casts(modules[table], f"intersect_{table}",
                                     ct.Renderer(scene, seed=1, device=dev),
                                     calls=tuple(cast_names))
            for i, cname in cast_names.items():
                c = casts.pop(i)
                label = f"wave_order {name} {layout} {cname}"
                figures = order_casts(label, c, table, scene)
                entry = cell["casts"].setdefault(cname, dict(
                    rays=c["origin"].shape[0], any_hit=c["any_hit"],
                    active=int(c["active"].sum())))
                if layout == "raster":
                    entry.update(raster_ms=figures["ms"],
                                 key_order_ms=figures["key_order_ms"],
                                 glue_ms=figures["glue_ms"],
                                 key_order_with_glue_ms=figures[
                                     "key_order_with_glue_ms"])
                else:
                    entry["wave_order_ms"] = figures["ms"]
                del c
            del casts
            torch.cuda.empty_cache()
        wave[name] = cell
        emit(phase="wave_order", name=name, width=w, height=h, spp=2, **cell)
    # the device's busy share over one sample (after one to warm up)
    busy = {}
    traces = os.path.join(ROOT, "output", "chip_smoke_traces")
    for name, scene in (("teapots_512", teapots), ("sponza_1080p", sponza)):
        for oname in ("raster", "auto"):
            with environment(**orders[oname]):
                r = ct.Renderer(scene, seed=0, device=dev)
                r.run_sample()
                r.block()
                logdir = os.path.join(traces, f"{name}_{oname}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with trace_to(logdir):
                    r.run_sample()
                busy[f"{name} {oname}"] = dict(
                    device_busy(logdir),
                    traced_sample_s=time.perf_counter() - t0)
                del r
    import shutil

    shutil.rmtree(traces, ignore_errors=True)
    emit(phase="wave_order_busy", **busy)
    # CLIVE2_CONNECT_K=4 against K=0: one sample each, the same key
    states, k_counts = {}, {}
    for k in ("0", "4"):
        with environment(CLIVE2_CONNECT_K=k):
            r = ct.Renderer(dragon, seed=0, device=dev)
            out = {}
            k_counts[k] = drive(f"connect_k {k} medium_dragon_512",
                                queued + ("stream2_thread",),
                                lambda: out.update(times=samples(r, 1)))
            states[k] = {key: v.clone() for key, v in r.state.items()}
            k_counts[k]["s_per_sample"] = out["times"]
            del r
    connect_k = dict(agree(states["4"], states["0"]), **{
        f"k{k}": v for k, v in k_counts.items()})
    del states
    # a morton render on the card against the CPU's (BVH2 there, the
    # gather walk here), both forced to morton
    imgs = {}
    with environment(CLIVE2_WAVE_ORDER="morton"):
        for device in ("cpu", "cuda"):
            r = ct.Renderer(ct.create_scene_from_preset(
                "teapots", 64, 64, device=device), seed=3)
            if device == "cuda":
                drive("wave_order cpu_vs_card", ("bvh2",), r.run_sample)
            else:
                r.run_sample()
            imgs[device] = r.state["summed_image"].cpu().numpy()
    close = np.isclose(imgs["cuda"], imgs["cpu"], rtol=1e-3,
                       atol=1e-6).all(-1)
    emit(phase="wave_order_checks", connect_k_medium_dragon_512=connect_k,
         teapots_64_morton_cpu_vs_card=dict(
             pixels_close=float(close.mean()),
             image_mean=float(imgs["cuda"].mean())))
    if connect_k["share"] < 0.999:
        raise AssertionError(f"CLIVE2_CONNECT_K=4 differs from the full "
                             f"connection cast: {connect_k}")
    if close.mean() < 0.99:
        raise AssertionError("teapots under morton: card and CPU renders "
                             "disagree")
    del scene, ab_scenes, sponza, sponza_s1, dragon, dragon_w, dragon_s1
    torch.cuda.empty_cache()
    # the verify skill's health band for the Cornell preset at 16:9 (the
    # mean depends on the aspect ratio: ~0.0058 at 1:1, ~0.0101 at 16:9)
    mean_c = slices["cornell_1080p"]["image_mean"]
    if not 0.0095 <= mean_c <= 0.011:
        raise AssertionError(f"Cornell image mean {mean_c} outside the "
                             "16:9 health band 0.0095-0.011")

    # ---- 7c. camera moves: the movie --------------------------------------
    # bench.py's movie_720p: teapots 1280x720, 3 orbit frames of 120 at 2
    # spp, each with seed = frame as the movie CLI renders them.  Frame 0 is
    # built by create_scene_from_preset_with_params, frames 1-2 are moved by
    # with_camera (the BVH and the BVH2 tables shared with frame 0).  Frame 2
    # against a full rebuild at its camera, its connection cast held to the
    # plain walk; then one with_camera frame of Cornell 1080p, whose brute
    # table's sensor rows change, its connection cast held to brute_plain
    from clive2_tpu_torch.integrator.render import render_sample

    w, h, total = 1280, 720, 120
    t0 = time.perf_counter()
    base = ct.create_scene_from_preset_with_params("teapots", w, h, 0, total,
                                                   device=dev)
    torch.cuda.synchronize()
    movie = dict(scene_build_s=time.perf_counter() - t0, with_camera_ms=[],
                 s_per_frame=[], s_per_sample=[], image_mean=[])
    base_camtri = base.data["camtri"]["v0"].clone()
    frames = {}

    def run_movie():
        for f in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scene = base if f == 0 else base.with_camera(
                ct.orbit_camera(f, total, w, h))
            if f:
                torch.cuda.synchronize()
                movie["with_camera_ms"].append(
                    1e3 * (time.perf_counter() - t0))
            r = ct.Renderer(scene, seed=f, device=dev)
            movie["s_per_sample"] += samples(r, 2)
            img = r.raw_image
            movie["s_per_frame"].append(time.perf_counter() - t0)
            image_ok(f"movie frame {f}", img)
            movie["image_mean"].append(float(img.mean()))
            frames[f] = scene

    ran = drive("movie teapots", ("bvh2",), run_movie)
    moved = frames[2]
    if not (moved.data["bvh2"] is base.data["bvh2"]
            and moved.data["bvh"] is base.data["bvh"]):
        raise AssertionError("movie: with_camera copied the BVH tables")
    if not torch.equal(base.data["camtri"]["v0"], base_camtri) or \
            torch.equal(moved.data["camtri"]["v0"], base_camtri):
        raise AssertionError("movie: with_camera changed the base scene's "
                             "sensor or left the frame's in place")
    full = ct.create_scene_from_preset_with_params("teapots", w, h, 2, total,
                                                   device=dev)
    movie["rebuild_vs_with_camera"] = agree(
        render_sample(rng.key(2, dev), moved.data, w, h),
        render_sample(rng.key(2, dev), full.data, w, h))
    del full
    if movie["rebuild_vs_with_camera"]["share"] < 0.999:
        raise AssertionError(f"movie: frame 2 through with_camera differs "
                             f"from a rebuild: {movie}")
    casts = record_casts(traverse_bvh2, "intersect_bvh2",
                         ct.Renderer(moved, seed=2, device=dev))
    rays = 36 * w * h
    held_m = held_cast(
        "bvh2 movie frame 2 connection", casts[rays],
        lambda c: launch("bvh2", c, moved.data),
        lambda c: intersect.intersect_bvh_packed(
            c["origin"], c["direction"], moved.data["bvh"],
            active=c["active"], t_max=c["t_max"]),
        {k: moved.data["bvh2"][k] for k in ("nodes", "tris")},
        stride=-(-rays // (1 << 20)))
    err["bvh2"] = max(err["bvh2"], held_m["max_abs_err_t"])
    held_m.update(launches=ran["bvh2"] // 6, launches_per_frame=ran["bvh2"]
                  // 3)
    extra_casts["bvh2", "movie_connection"] = dict(
        held_m, cast="teapots 1280x720 orbit frame 2 (with_camera) "
        "connection")
    del casts, frames, base

    tris0 = cornell.data["brute"]["tris"].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cmoved = cornell.with_camera(ct.orbit_camera(1, total, 1920, 1080))
    torch.cuda.synchronize()
    cornell_ms = 1e3 * (time.perf_counter() - t0)
    tris_m = cmoved.data["brute"]["tris"]
    if torch.equal(tris_m, tris0) or not torch.equal(
            cornell.data["brute"]["tris"], tris0):
        raise AssertionError("movie: the Cornell brute table was not moved, "
                             "or the base scene's was")
    r = ct.Renderer(cmoved, seed=1, device=dev)
    out = {}
    ran_c = drive("movie cornell", ("brute",),
                  lambda: out.update(times=samples(r, 1)))
    image_ok("movie cornell", r.raw_image)

    def moved_cast(fn):
        return lambda c: fn(c["origin"], c["direction"], tris_m,
                            active=c["active"], t_max=c["t_max"])

    casts = record_casts(brute, "intersect_brute",
                         ct.Renderer(cmoved, seed=1, device=dev))
    held_c = held_cast("brute cornell with_camera connection",
                       casts[36 * 1920 * 1080],
                       moved_cast(brute.intersect_brute),
                       moved_cast(brute.brute_plain), cmoved.data["brute"])
    err["brute"] = max(err["brute"], held_c["max_abs_err_t"])
    held_c.update(launches=ran_c["brute"], launches_per_frame=ran_c["brute"])
    extra_casts["brute", "with_camera_connection"] = dict(
        held_c, cast="Cornell 1920x1080 orbit frame 1 (with_camera) "
        "connection, 1 spp")
    emit(phase="movie", scene="teapots", width=w, height=h, frames=3, spp=2,
         counts=ran, connection_cast=held_m, **movie,
         cornell_1080p=dict(with_camera_ms=cornell_ms,
                            s_per_sample=out["times"], counts=ran_c,
                            image_mean=float(r.raw_image.mean()),
                            connection_cast=held_c))
    del r, casts, cmoved, tris_m, tris0
    torch.cuda.empty_cache()

    # ---- 7d. tiles: Renderer(mesh=) ---------------------------------------
    # One card, so the mesh runs as an NCCL group of one rank (the real
    # collective) and as two gloo ranks on cuda:0 (spawned, under a time
    # limit), each against a plain Renderer sample of the same seed.  Not a
    # speed claim: two ranks share one card.
    import shutil

    import torch.distributed as dist

    from clive2_tpu_torch.parallel import make_tile_mesh
    from clive2_tpu_torch.testing import mesh_render, spawn_ranks

    work = os.path.join(ROOT, "output", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tiles, single, one_counts, banded = {}, {}, {}, {}
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                            rank=0, world_size=1)
    try:
        mesh = make_tile_mesh(devices="cuda:0")
        for name, scene, kernel in (("cornell_1080p", cornell, "brute"),
                                    ("teapots_512", teapots, "bvh2")):
            r1 = ct.Renderer(scene, seed=0, device=dev)
            one, out = {}, {}
            one_counts[name] = drive(f"tiles one device {name}", (kernel,),
                                     lambda: one.update(times=samples(r1, 1)))
            single[name] = {k: v.cpu().numpy() for k, v in r1.state.items()}
            # what two ranks render, on this device: in morton order each
            # band is ordered in place, so it is another sample than one
            # device's whole frame
            banded[name] = tiles_on_one_device(scene, 0, 2)
            rm = ct.Renderer(scene, seed=0, device=dev, mesh=mesh)
            ran = drive(f"tiles nccl {name}", (kernel,),
                        lambda: out.update(times=samples(rm, 1)))
            tiles[name] = dict(order=wave_order(scene.data),
                               s_per_sample_plain=one["times"],
                               s_per_sample_nccl_1=out["times"], counts=ran,
                               nccl_1_vs_plain=agree(rm.state, r1.state))
            if ran != one_counts[name]:
                raise AssertionError(f"tiles: a one-rank NCCL mesh launched "
                                     f"{ran}, one device {one_counts[name]}")
            if tiles[name]["nccl_1_vs_plain"]["share"] < 0.999:
                raise AssertionError(f"tiles: a one-rank NCCL mesh differs "
                                     f"from one device: {tiles[name]}")
            del r1, rm
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    jobs = [("cornell_1080p", "empty", 1920, 1080, 0, 1),
            ("teapots_512", "teapots", 512, 512, 0, 1)]
    t0 = time.perf_counter()
    spawn_ranks(mesh_render, 2, os.path.join(work, "gloo"),
                args=("cuda:0", jobs), timeout=300)
    spawn_s = time.perf_counter() - t0
    for name, kernel in (("cornell_1080p", "brute"), ("teapots_512", "bvh2")):
        a, b = (dict(np.load(os.path.join(work, "gloo",
                                          f"{name}-rank{r}.npz")))
                for r in range(2))
        for k in single[name]:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"tiles: the gloo ranks' {k} differ")
        # each rank's tile casts once where one device casts the frame,
        # and no cast of either rank takes a plain version
        for rank, got in enumerate((a, b)):
            ran = {k[9:]: int(got[k]) for k in got
                   if k.startswith("launches/")}
            check_launches(f"tiles gloo {name} rank {rank}", (kernel,), ran)
            if {k: v for k, v in ran.items() if v} != one_counts[name]:
                raise AssertionError(f"tiles: gloo rank {rank} launched "
                                     f"{ran}, one device {one_counts[name]}")
        tiles[name].update(
            s_per_sample_gloo_2=[float(x) for x in a["seconds"]],
            gloo_2_launches={k[9:]: int(a[k]) for k in a
                             if k.startswith("launches/") and a[k]},
            gloo_2_vs_plain=agree(a, single[name]),
            gloo_2_vs_tiles_one_device=agree(a, banded[name]))
        # raster order: the ranks' sample is one device's; morton: it is
        # the two tiles' sample rendered on one device
        key = ("gloo_2_vs_plain" if tiles[name]["order"] == "raster"
               else "gloo_2_vs_tiles_one_device")
        if tiles[name][key]["share"] < 0.999:
            raise AssertionError(f"tiles: two gloo ranks differ from one "
                                 f"device: {tiles[name]}")
    emit(phase="tiles", spawn_s=spawn_s, **tiles)

    # ---- 7e. the CLIs, as subprocesses ------------------------------------
    clis = {}
    for name, argv, want in (
            ("render", ["--scene", "empty", "--width", "1920", "--height",
                        "1080", "--samples", "2"], 1),
            ("movie", ["--scene", "teapots", "--width", "320", "--height",
                       "180", "--samples", "1", "--movie-frames", "3"], 3)):
        out_dir = os.path.join(work, f"cli_{name}")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", f"clive2_tpu_torch.apps.{name}", *argv,
             "--output-dir", out_dir], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        wall = time.perf_counter() - t0
        if p.returncode:
            raise AssertionError(f"{name} CLI exited {p.returncode}:\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        pngs = [os.path.join(d, f) for d, _, fs in os.walk(out_dir)
                for f in fs if f.endswith(".png")]
        if len(pngs) != want:
            raise AssertionError(f"{name} CLI wrote {pngs}, expected {want}")
        clis[name] = dict(argv=argv, wall_s=wall, pngs=len(pngs),
                          last_line=p.stdout.strip().splitlines()[-1])
    emit(phase="cli", **clis)
    shutil.rmtree(work, ignore_errors=True)

    # ---- 8. the same small render on the CPU and on the card --------------
    imgs = {}
    for device in ("cpu", "cuda"):
        r = ct.Renderer(ct.create_scene_from_preset("empty", 64, 64,
                                                    device=device), seed=3)
        r.run_sample()
        imgs[device] = r.state["summed_image"].cpu().numpy()
    a, b = imgs["cuda"], imgs["cpu"]
    close = np.isclose(a, b, rtol=1e-3, atol=1e-6).all(-1)
    mean_rel = float(abs(a.mean() - b.mean()) / abs(b.mean()))
    emit(phase="cpu_vs_card", size=64, spp=1, pixels_close=float(close.mean()),
         mismatch_fraction=float(1 - close.mean()), mean_rel_err=mean_rel)
    if close.mean() < 0.99 or mean_rel > 1e-3:
        raise AssertionError("card and CPU renders disagree")

    # ---- 9. summary ------------------------------------------------------
    # times: brute on Cornell 1080p's and BVH2 on teapots 512's connection
    # casts (where their time goes), the
    # streaming kernel on the medium dragon's and the wide kernel on the
    # dragon's extension cast (plain versions on every ray), the queued
    # fat-leaf traversal and the per-thread fat-leaf kernel on sponza
    # 1080p's connection cast (the plain walk on every 72nd ray:
    # plain_rays), and the queued traversal's kernels on one round of its
    # first chunk (2^22 rays); every cast is in phase 5's lines.
    # library_ms: one PyTorch call that computes the same function, where
    # there is one, else null and library_note says why
    no_cast_call = ("no PyTorch call computes a closest-hit or any-hit "
                    "cast against triangles")
    notes = dict(
        stream2_walk="no PyTorch call walks a BVH",
        stream2_plan=("no single PyTorch call pads counts to whole tiles "
                      "and scans them (torch.cumsum is the scan alone)"),
        stream2_scatter=("no single PyTorch call places rays into padded "
                         "per-leaf ranges (a stable sort gives the order "
                         "alone)"),
        stream2_leaf=no_cast_call, stream2_tail=no_cast_call)

    def cast_row(name, src, tpu, key):
        ms, plain_ms = timing[key]
        b_ms, b_by = bounds[key]
        return dict(name=name, route="cuda",
                    source=f"clive2_tpu_torch/csrc/{src}",
                    replaces=f"clive2_tpu/ops/{tpu}", launches=launches[name],
                    max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    library_note=no_cast_call,
                    cast=" ".join(key[1:]), plain_rays=compared[key])

    rows = [
        cast_row("brute", "brute.cu", "brute_pallas.py:29",
                 ("brute", "connection")),
        cast_row("bvh2", "traverse_bvh2.cu", "traverse_pallas2.py:144",
                 ("bvh2", "connection")),
        cast_row("stream2", "stream2_queue.cu", "traverse_stream2.py:191",
                 ("stream2", "sponza", "connection")),
        cast_row("wide", "traverse_wide.cu", "traverse_wide.py:128",
                 ("wide", "dragon", "extension")),
        cast_row("stream", "traverse_stream.cu", "traverse_stream.py:104",
                 ("stream", "medium_dragon", "extension"))]
    rows[0]["pretest_end_share"] = pretest_of["connection"][
        "pretest_end_share"]
    rows[3]["dragon_connection"] = dict(
        zip(("ms", "plain_ms"), timing["wide", "dragon", "connection"]),
        bound_ms=bounds["wide", "dragon", "connection"][0],
        plain_rays=compared["wide", "dragon", "connection"])
    rows[4]["sponza_connection"] = dict(
        zip(("ms", "plain_ms"), timing["stream", "sponza", "connection"]),
        bound_ms=bounds["stream", "sponza", "connection"][0])
    rows[2]["launches_are"] = ("queued casts; their kernels' launches are "
                               "the stream2_* rows")
    sponza_parts = parts_of["sponza", "connection"]
    for name, part, src in (
            ("stream2_walk", "walk", "stream2_queue.cu"),
            ("stream2_count", "count", "stream2_queue.cu"),
            ("stream2_plan", "plan", "stream2_queue.cu"),
            ("stream2_scatter", "scatter", "stream2_queue.cu"),
            ("stream2_leaf", f"leaf_{s2.LEAF_TEST}", "stream2_queue.cu"),
            ("stream2_tail", "tail", "traverse_stream2.cu")):
        v = sponza_parts[part]
        b_ms, b_by = bound(v["bytes"], v["ops"])
        lib_ms = v.get("library_ms")
        rows.append(dict(
            name=name, route="cuda", source=f"clive2_tpu_torch/csrc/{src}",
            replaces="clive2_tpu/ops/traverse_stream2.py:191",
            launches=launches[name], max_abs_err=v["max_abs_err"],
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
            **({"library_call": "torch.bincount"} if lib_ms is not None
               else {"library_note": notes[name]}),
            cast="sponza connection, first chunk, one round"))
    other = "tf32" if s2.LEAF_TEST == "fp32" else "fp32"
    rows[-2][f"ab_{other}_ms"] = sponza_parts[f"leaf_{other}"]["ms"]
    # the per-thread kernel: the whole of sponza's connection cast (A/B)
    thread_ms = timing["stream2", "sponza", "connection per_thread"]
    b_ms, b_by = bounds["stream2", "sponza", "connection"]
    rows.append(dict(
        name="stream2_thread", route="cuda",
        source="clive2_tpu_torch/csrc/traverse_stream2.cu",
        replaces="clive2_tpu/ops/traverse_stream2.py:191",
        launches=launches["stream2_thread"],
        max_abs_err=err["stream2_thread"], ms=thread_ms,
        plain_ms=timing["stream2", "sponza", "connection"][1],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note=no_cast_call, cast="sponza connection",
        plain_rays=compared["stream2", "sponza", "connection"]))
    # the casts of this slice's other paths, beside the main path's rows
    for (name, cast), figures in extra_casts.items():
        next(row for row in rows if row["name"] == name)[cast] = figures
    # each traversal's casts in raster, Morton wave and Morton-key order
    for name, cell in (("bvh2", "teapots_512"), ("wide", "dragon_512_wide"),
                       ("stream2", "sponza_1080p"),
                       ("stream", "sponza_1080p_stream1")):
        next(row for row in rows if row["name"] == name)["wave_order"] = dict(
            cell=cell, casts=wave[cell]["casts"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sass":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps(sass_figures(sys.argv[2])), flush=True)
        sys.exit(0)
    try:
        code = main()
    except Exception as e:                 # report the phase that failed
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
