"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clive2_tpu_torch/csrc, holds each
against its plain PyTorch version on the card (on synthetic ray sets, then
on the casts the main path itself gives the kernel, recorded from one
sample of each configuration; the queued fat-leaf traversal also kernel by
kernel on one round of the first chunk of each of its casts), times both on
those casts (and, on the BVH scenes' casts, the other kernels that can carry
the scene as an A/B: on the fat-leaf casts also the per-thread fat-leaf
kernel and other tail sizes), holds the BVH2, BVH8 and streaming kernels to
a soup of exact ties, reports the SASS instructions per triangle test and
the persistent traversal kernels' registers, shared memory, spills and
resident blocks, then
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
and ``sponza`` at 1920x1080 on the same tables (streaming kernel).
``big-dragon`` (871,422 mesh triangles) at bench.py's 512x512 and 4 spp
on its default route (``big_dragon_512``: the queued fat-leaf traversal)
and on BVH2 tables under ``CLIVE2_TRAVERSAL=pallas2``
(``big_dragon_512_bvh2_ab``), each with s/sample, Mrays/s, peak memory,
scene build and launches by kernel, its casts held to the plain walks on a
stride, and the two routes' images against each other.  Then
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
render in Morton order.  Then the port's counterparts of the JAX
package's tools in scripts/ that ran TPU kernels, each through its own
entry point with its launch counts (``packet_stats``: kernel_stats on
teapots 512 and dragon 512, three ray populations at packets of 1,024 and
32 rays, the packet walk kernel's counts, t and ids against its plain
version on every packet and ray, each cast timed by single launches and
from a CUDA graph, with the mean and most pops per packet;
``packet_ablation``:
kernel_microbench's five variants on teapots 512's connection casts beside
the BVH2 kernel on the same cast, and that kernel's mean over 5
back-to-back calls beside the host's time to issue them and the
allocator's cudaMalloc calls among them; ``link_probe``: the probe's phases and
verdict, its kernel bit for bit against a * 2 + 1, and the host µs per
launch of its wrapper beside ``torch.addcmul``'s; ``mosaic_probes``:
probe_mosaic_layouts's five probes, each OK only when its kernel equalled
its plain version (the bulk slab copy bit for bit, the two bf16 ``wgmma``
products within 2^-14 |A|ᵀ|B|), each kernel timed beside its plain
version and one PyTorch call (single launches and from a CUDA graph, as
the link probe's kernel too; the slab copy's bands), a K-major A against
a row-major one on the same product, and the product kernel's registers,
shared memory, spills, tile and grid beside the tile widths tried in PR
15; the packet walk also on the tie soup in phase 4).  Then the port's tools
that drive the renderer, each as a subprocess on the card (``tools``:
make_assets, smoke_render, profile_stages on teapots and big-dragon,
parity_render under both estimators and its report, movie_launcher with
two workers; the diagnostics diag_mis under both estimators, its default
run held to the JAX script's figures, shade_ab at two sizes, its lobes on
the card held to the CPU, and shadow_cache_study on dragon 512 and sponza
1080p), each failing the run on a nonzero exit.  Then it compares a
small render on the card with the same render on the CPU.  The
meshes are written into resources/ when missing (procedural stand-ins at
the reference's triangle counts, by clive2_tpu_torch/scripts/make_assets.py).  Each
phase prints one JSON line; any failure exits non-zero without the final
line.  Before the last line it prints the ``kernels`` line (each kernel's
launches on the main path, error, time, plain time, the time of the one
PyTorch call that computes the same function where there is one, and the
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s of FP32, counted from the work the plain walks
did in one call; the bf16 products' over 989 TFLOP/s of the tensor cores)
and the card's name and power limit.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports no JAX.

    python3 chip_smoke.py --sass LIBRARY

prints the SASS figures of a built kernel library (any checkout's
``clive2_tpu_torch/build/*.so``) and exits, so that two builds can be
compared on one machine.

The phase ``connect_kernels_vs_plain`` (after the main path's casts) holds
the connection's two kernels (csrc/connect.cu) to their plain versions on
one sample of Cornell and sponza at 1920x1080 and times each beside its
byte bound and its plain stage; the ``kernels`` line carries their rows.

    python3 chip_smoke.py --phase connect_kernels_vs_plain

runs that phase alone.

The phase ``rng_kernels_vs_plain`` (after the connection's) replays the
RNG calls of one sample of Cornell and sponza at 1920x1080 (4 draws, 15
key derivations) through the RNG's kernels (csrc/rng.cu) and their plain
versions: bit equality, CUDA-event times beside the bound (integer
operations), plain times and ptxas's figures; the ``kernels`` line
carries their rows.  A two-rank tile mesh's band of each frame holds the
draws that take rows (``rows=lanes``) bit for bit too.

    python3 chip_smoke.py --phase rng_kernels_vs_plain

runs that phase alone.

The phase ``shade_kernel_vs_plain`` (after the RNG's) replays the six
bounces of one sample of Cornell and sponza at 1920x1080 through the
trace's shading kernel (csrc/shade.cu) and its plain version: the same
bits on every output, CUDA-event times (median of 5) beside the byte
bound, ptxas's figures and nvcc's seconds for shade.cu and connect.cu
alone; the ``kernels`` line carries its row.

    python3 chip_smoke.py --phase shade_kernel_vs_plain

runs that phase alone.

The phase ``dragon_1080p`` (after the tools) renders the benchmark's
``dragon.1080p`` cell, the glass dragon at 1920x1080 on the BVH2 kernel,
and profiles a stretch of it: the program's counters, the specular share
of the stored vertices and the ``clive2.*`` spans a sample.

    python3 chip_smoke.py --phase dragon_1080p

runs that phase alone.
"""

from __future__ import annotations

import contextlib
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
BF16_TC_FLOPS_S = 989e12      # dense bf16 on the tensor cores
OPS = dict(boxes=25, triangles=50, slots=40)
# the bf16 product kernel's tile widths (kBN) and epilogues as measured in
# PR 15's chip calls 2-3 by a sweep tool that rebuilt the source with each
# variant and was not kept (NVIDIA H100 80GB HBM3, 700.00 W): ms per call
# from a CUDA graph, median of 4 rounds, beside torch.mm's in the same
# rounds; "32 direct" is the source's
MMA_TILES_TRIED = dict(
    source="PR 15 chip calls 2-3 (tile sweep, tool not kept)",
    dotT={"32 direct": 0.002340799942612648,
          "64 direct": 0.002505600079894066,
          "128 direct": 0.0028656000271439553,
          "32 tma_store": 0.0025296000763773917,
          "64 tma_store": 0.0028271999210119246,
          "128 tma_store": 0.003519999980926514,
          "torch.mm": 0.002812799997627735},
    dot128={"32 direct": 0.0025200000032782554,
            "64 direct": 0.00260000005364418,
            "128 direct": 0.0030767999589443205,
            "32 tma_store": 0.0027408000081777573,
            "64 tma_store": 0.0029967999085783958,
            "128 tma_store": 0.003691200166940689,
            "torch.mm": 0.0030735999345779417})


# the MIS diagnostic's figures as the JAX package's scripts/diag_mis.py
# prints them on the CPU for Cornell 32x32, key 7, 128 spp (jax 0.9.0;
# six significant digits): each class's unidirectional mean, and each
# strategy's unweighted and weighted means.  The port draws the same keys,
# so the card's run must read these up to near ties (DIAG_MIS_RTOL; the
# port on the CPU read them within 8.3e-5, an NVIDIA H100 80GB HBM3 at
# 700 W within 8.9e-5, and within 1.1e-4 of the script's 1,024-spp
# figures at 1,024 spp)
DIAG_MIS_SPP, DIAG_MIS_REF_SPP, DIAG_MIS_RTOL = 128, 64, 1e-3
DIAG_MIS_JAX_UNI = {2: 0.0411148, 3: 0.0150609, 4: 0.00590736,
                    5: 0.00401618, 6: 0.00251507}
DIAG_MIS_JAX = {
    "1,1": (0.0413312, 0.0357351), "2,0": (0.0411148, 0.00556404),
    "1,2": (0.0149499, 0.00173365), "2,1": (0.0150915, 0.0128115),
    "3,0": (0.0150609, 0.000539232), "1,3": (0.00574054, 0.00060658),
    "2,2": (0.0057406, 0.00226566), "3,1": (0.0057713, 0.00282488),
    "4,0": (0.00590736, 7.93867e-05), "1,4": (0.00409918, 0.000271728),
    "2,3": (0.00400814, 0.00111812), "3,2": (0.00403361, 0.00113615),
    "4,1": (0.0040403, 0.00145452), "5,0": (0.00401618, 3.91813e-05),
    "1,5": (0.0024916, 0.000136326), "2,4": (0.00244807, 0.000544113),
    "3,3": (0.00246643, 0.000529627), "4,2": (0.00240736, 0.000548016),
    "5,1": (0.00247601, 0.000688438), "6,0": (0.00251507, 1.79132e-05),
    "1,6": (0.00170313, 7.46561e-05), "2,5": (0.00162389, 0.000301855),
    "3,4": (0.00160113, 0.000291494), "4,3": (0.00161066, 0.000287912),
    "5,2": (0.00162661, 0.000302613), "6,1": (0.00164169, 0.000374199),
    "2,6": (0.00106441, 0.000169006), "3,5": (0.00107872, 0.000163495),
    "4,4": (0.0010351, 0.000160432), "5,3": (0.00103179, 0.000162033),
    "6,2": (0.00106361, 0.00016941), "3,6": (0.000719966, 9.5951e-05),
    "4,5": (0.000700421, 9.40932e-05), "5,4": (0.000709732, 9.36396e-05),
    "6,3": (0.000750703, 9.49162e-05), "4,6": (0.0004868, 5.53802e-05),
    "5,5": (0.000471356, 5.52831e-05), "6,4": (0.000504829, 5.5432e-05),
    "5,6": (0.00031867, 3.36106e-05), "6,5": (0.000316817, 3.36141e-05),
    "6,6": (0.000222725, 2.04808e-05)}


def mis_gate(fig):
    """The MIS diagnostic's run (its JSON line) against the estimator's
    identity and the JAX script's figures: every one of the 41 strategies
    present with finite figures; each (t, 0) strategy of classes 2-6 the
    class's unidirectional image (rtol 1e-6); every unidirectional,
    unweighted and weighted mean within DIAG_MIS_RTOL of the script's.
    The ratios to uni that tests/test_convergence.py bands (1.5% per
    strategy, 1% for the weighted sum) are in the figures; at this spp the
    script's own run misses those bands on many of them (noise, not the
    port), and where it keeps them the comparison above keeps the port's.
    Returns the failures."""
    import math

    bad = []
    classes = fig["classes"]
    got = {ts: v for c in classes.values()
           for ts, v in c["strategies"].items()}
    if fig["n_strategies"] != 41 or sorted(got) != sorted(DIAG_MIS_JAX):
        return [f"strategies {sorted(got)}"]
    for ts, v in got.items():
        if not all(math.isfinite(v[x])
                   for x in ("unweighted", "weighted", "wmean")):
            bad.append(f"{ts}: not finite {v}")
        for x, want in zip(("unweighted", "weighted"), DIAG_MIS_JAX[ts]):
            if abs(v[x] - want) > DIAG_MIS_RTOL * abs(want):
                bad.append(f"{ts} {x} {v[x]} against the script's {want}")
    for k, want_uni in DIAG_MIS_JAX_UNI.items():
        c = classes[str(k)]
        uni = c["uni"]
        if abs(uni - want_uni) > DIAG_MIS_RTOL * want_uni:
            bad.append(f"class {k} uni {uni} against {want_uni}")
        t0 = c["strategies"][f"{k},0"]["unweighted"]
        if abs(t0 - uni) > 1e-6 * uni:
            bad.append(f"({k},0) {t0} is not uni {uni}")
    return bad


def shade_gate(x, shade_ab):
    """The shading A/B's all_lobes on the card against the same function
    on the CPU on the card's inputs ``x``, and both against its float64
    evaluation on the CPU.  Per output (wo, f, c_p, l_p): the share of
    lanes equal at rtol 1e-5 / atol 1e-6, the largest relative
    difference, and each one's lanes outside that tolerance of float64.
    Fails unless at least 99% of lanes are equal at that tolerance and
    the card misses float64 on no more lanes than 1.1x the CPU's float32
    result does, plus 16: GGX's D and Jacobians and the Fresnel select
    amplify the two libraries' ulps on ill-conditioned lanes, where float32
    itself cannot meet the tolerance.  Returns (figures, failures)."""
    import numpy as np

    card = [t.cpu().numpy() for t in shade_ab.all_lobes(x)]
    host = {k: v.cpu() for k, v in x.items()}
    cpu = [t.numpy() for t in shade_ab.all_lobes(host)]
    f64 = [t.numpy() for t in shade_ab.all_lobes(
        {k: v.double() if v.is_floating_point() else v
         for k, v in host.items()})]
    figures, bad = {}, []
    for name, a, b, r in zip(("wo", "f", "c_p", "l_p"), card, cpu, f64):
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        fig = dict(equal_share=float(close.mean()),
                   lanes_not_equal=int((~close).sum()),
                   max_rel=float(rel.max()), finite=bool(np.isfinite(a).all()),
                   card_off_f64=int((~np.isclose(a, r, rtol=1e-5,
                                                 atol=1e-6)).sum()),
                   cpu_off_f64=int((~np.isclose(b, r, rtol=1e-5,
                                                atol=1e-6)).sum()))
        figures[name] = fig
        if not fig["finite"] or fig["equal_share"] < 0.99 or \
                fig["card_off_f64"] > 1.1 * fig["cpu_off_f64"] + 16:
            bad.append(f"{name}: {fig}")
    return figures, bad


def emit(**kv):
    print(json.dumps(kv), flush=True)


def ptxas_figures(report, tag_of):
    """Registers, static shared memory bytes and spill-store bytes of each
    kernel instance in ptxas's report that ``tag_of(mangled name)`` names
    (None: not reported)."""
    figures = {}
    for part in report.split("Compiling entry function")[1:]:
        tag = tag_of(part.split("'", 2)[1])
        if tag is None:
            continue
        smem = re.search(r"(\d+) bytes smem", part)
        figures[tag] = dict(
            registers=int(re.search(r"Used (\d+) registers", part).group(1)),
            static_smem_bytes=int(smem.group(1)) if smem else 0,
            spill_store_bytes=int(re.search(r"(\d+) bytes spill stores",
                                            part).group(1)))
    return figures


def mma_tag(name):
    """The bf16 product kernel's instances in mosaic_probes.cu: matmul_t
    (A transposed) and matmul."""
    if "mma_kernel" not in name:
        return None
    return "matmul_t" if "ILb1E" in name else "matmul"


PACKET_KERNEL = re.compile(
    r"packet_walk_kernelILi(\d+)ELi\d+ELi(\d)ELi(\d)ELb([01])E")


def packet_tag(name):
    """A packet walk kernel instance (csrc/packet_walk.cu) by its variant,
    packet size and counting, e.g. "noreduce [1024] count"."""
    from clive2_tpu_torch.ops.packet_walk import VARIANTS

    m = PACKET_KERNEL.search(name)
    if m is None:
        return None
    modes = (("skip", "always", "none")[int(m.group(2))],
             ("tmin", "fixed", "any")[int(m.group(3))])
    variant = next(k for k, v in VARIANTS.items() if v == modes)
    return f"{variant} [{m.group(1)}]" + (" count" if m.group(4) == "1"
                                          else "")


def resident_blocks(registers, smem, threads):
    """Blocks of ``threads`` an H100 SM holds with ptxas's figures: 65,536
    registers allocated in 8 a thread, 2,048 threads, 228 KB of shared
    memory of which each block reserves 1 KB, at most 32 blocks."""
    regs = -(-registers // 8) * 8
    return min(65536 // (regs * threads), 2048 // threads,
               (228 << 10) // (smem + 1024), 32)


def work_ops(work, scale=1):
    """Operations of the work a plain walk counted, times ``scale``."""
    return scale * sum(OPS[k] * v for k, v in work.items())


def bound(nbytes, ops, flops_s=FP32_FLOPS_S):
    """The least time the card could take: (ms, what binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / flops_s
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


def sass_code(library):
    """{mangled kernel name: [(address, instruction)]} of a built
    library's SASS (``cuobjdump -sass``)."""
    from clive2_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {part.split("\n", 1)[0].strip(): [
        (int(a, 16), ins.strip()) for a, ins in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        for part in re.split(r"\n\s*Function : ", text)[1:]}


def sass_figures(library, kernels_of=("brute_kernel", "bvh2_kernel",
                                      "stream_kernel", "wide_kernel",
                                      "packet_walk_kernel")):
    """SASS instruction counts of the named kernels in a built library
    (``cuobjdump -sass``): per kernel instance, its instructions, those of
    its largest loop (a walk's step, with any loop nested in it), and for
    the innermost loop that holds a MUFU.RCP (the triangle test's
    1 / a), its instructions, its MUFU.RCPs and their ratio, the
    instructions per triangle test that reaches the division (the loop
    unrolled k times holds k of them)."""
    out = {}
    for name, code in sass_code(library).items():
        short = next((k for k in kernels_of if k in name), None)
        if short is None:
            continue
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
        outer = max(loops, key=lambda lh: lh[1] - lh[0], default=None)
        tag = packet_tag(name) if short == "packet_walk_kernel" else (
            "any_hit" if "ILb1E" in name else (
                "closest" if "ILb0E" in name else ""))
        out[f"{short} {tag}".strip()] = dict(
            instructions=len(addr),
            outer_loop=None if outer is None else sum(
                outer[0] <= a <= outer[1] for a in addr),
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


def connect_tag(name):
    """A connection kernel instance (csrc/connect.cu) by its stage and
    template flag: rays (any_hit | closest) or shade (corrected |
    reference)."""
    flag = "ILb1E" in name
    if "connect_rays_kernel" in name:
        return "rays any_hit" if flag else "rays closest"
    if "connect_shade_kernel" in name:
        return "shade reference" if flag else "shade corrected"
    return None


def connect_bytes(n, max_bounces, reference, pixels):
    """The least bytes each connection kernel moves for ``n`` lanes: every
    vertex field it reads once (stage A: each subpath's origin, normal and
    material; stage B: origin, direction, normal, color, three importances,
    material, triangle, and the camera's hit_light; the light subpath's
    triangle only under the reference estimator), the lengths, the cast's
    [P, N] answers; its outputs written once, the light images (``pixels``
    of 16 B) among them."""
    p = max_bounces ** 2
    rays = n * (max_bounces * 2 * 28 + 8 + p * (12 + 12 + 1 + 4))
    camera = 48 + 12 + 12         # 4 vectors, 3 importances, 3 ids
    light = 48 + 12 + 4 + 4 * reference
    shade = n * (max_bounces * (camera + light) + 4 + p * (4 + 4 + 1)
                 + 16) + 16 * pixels
    return dict(rays=rays, shade=shade)


def median_event_ms(fn, reps):
    """The median over ``reps`` calls of ``fn`` of its CUDA-event
    milliseconds, each call synchronised."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def connect_kernels_vs_plain(scenes, seed=5):
    """Phase ``connect_kernels_vs_plain``: on one sample of each of
    ``scenes`` ((name, scene, width, height)), in the renderer's wave
    order, each connection kernel against its plain version on the same
    inputs (stage B on the cast of the plain version's rays): the largest
    differences and the tests' tolerances held; each kernel's CUDA-event
    time (median of 5 calls of its wrapper, the light images' zero fill
    included) beside its byte bound, and the plain stage's (one call);
    ptxas's registers and spills.  Returns the figures by scene."""
    import torch

    from clive2_tpu_torch import kernels, rng
    from clive2_tpu_torch.integrator import connect, render

    ms = median_event_ms

    def rel(a, b):
        d = (a - b).abs() / b.abs().clamp(min=1e-30)
        d = d[torch.isfinite(d) & (a != b)]
        return float(d.max()) if d.numel() else 0.0

    resources = ptxas_figures(kernels.ptxas_report("connect.cu"),
                              connect_tag)
    out = {}
    for name, scene, w, h in scenes:
        dev = scene.data["camera"]["center"].device
        wf = render.trace_wavefront(
            rng.key(seed, dev), scene.data, w, h,
            order=render._wave_order(scene.data))
        cam, light = wf["cam_path"], wf["light_path"]
        n = cam["length"].shape[0]
        pairs = connect.connection_pairs()
        any_hit = connect.any_hit_casts()
        got_a = connect.rays_kernel(cam, light, scene.data, pairs, any_hit)
        want_a = connect.connection_rays_plain(cam, light, scene.data,
                                               pairs, None, None, any_hit)
        tri, t = connect.cast_connections(*want_a, scene.data, any_hit,
                                          wf["connect_sort"])
        args = (cam, light, scene.data, tri, t, want_a[2], w, h)
        got_b = connect.shade_kernel(*args)
        want_b = connect.shade_plain(*args)
        figures = dict(
            lanes=n, order=render._wave_order(scene.data),
            origin_equal=bool(torch.equal(got_a[0], want_a[0])),
            active_differing=int((got_a[2] != want_a[2]).sum()),
            n_rays=int(want_a[2].sum()),
            direction_max_abs=float((got_a[1] - want_a[1]).abs().max()),
            t_max_max_rel=rel(got_a[3], want_a[3]),
            contribution_max_rel=rel(got_b[0], want_b[0]),
            weight_sum_max_rel=rel(got_b[1], want_b[1]),
            light_image_max_abs=float((got_b[2] - want_b[2]).abs().max()),
            light_weight_max_abs=float((got_b[3] - want_b[3]).abs().max()))
        torch.testing.assert_close(got_a[1], want_a[1], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got_a[3], want_a[3], rtol=1e-6, atol=0,
                                   equal_nan=True)
        for a, b in zip(got_b[:2], want_b[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        for a, b in zip(got_b[2:], want_b[2:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        if not figures["origin_equal"] or figures["active_differing"]:
            raise AssertionError(f"connect_kernels_vs_plain {name}: "
                                 f"{figures}")
        del got_a, got_b, want_b
        torch.cuda.empty_cache()
        bound = connect_bytes(n, 6, False, w * h)
        times = dict(
            rays=ms(lambda: connect.rays_kernel(cam, light, scene.data,
                                                pairs, any_hit), 5),
            shade=ms(lambda: connect.shade_kernel(*args), 5),
            rays_plain=ms(lambda: connect.connection_rays_plain(
                cam, light, scene.data, pairs, None, None, any_hit), 1),
            shade_plain=ms(lambda: connect.shade_plain(*args), 1))
        for k in ("rays", "shade"):
            figures[k] = dict(
                ms=times[k], plain_ms=times[k + "_plain"],
                bytes=bound[k], bound_ms=bound[k] / HBM_BYTES_S * 1e3,
                bound_by="bytes",
                bound_share=bound[k] / HBM_BYTES_S * 1e3 / times[k])
        out[name] = figures
        del want_a, tri, t, args, wf, cam, light
        torch.cuda.empty_cache()
    emit(phase="connect_kernels_vs_plain", resources=resources, **out)
    return dict(resources=resources, **out)


def connect_phase_alone() -> int:
    """``--phase connect_kernels_vs_plain``: that phase alone, on Cornell
    and sponza at 1920x1080 (the meshes written when missing)."""
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.scene import RESOURCE_DIR
    from clive2_tpu_torch.testing import write_assets

    dev = torch.device("cuda")
    kernels.load()
    write_assets(RESOURCE_DIR)
    connect_kernels_vs_plain(
        (("cornell_1080p", ct.create_scene_from_preset(
            "empty", 1920, 1080, device=dev), 1920, 1080),
         ("sponza_1080p", ct.create_scene_from_preset(
             "sponza", 1920, 1080, device=dev), 1920, 1080)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


DRAGON_SEED = 2147483953


def dragon_1080p(seed=DRAGON_SEED):
    """Phase ``dragon_1080p``: the ``dragon.1080p`` cell's session
    (``benchmark/modes/progressive.py``: the glass dragon preset at
    1920x1080 after the traffic's warm-up samples), as many samples as the
    traffic traces timed untraced, then one profiled stretch of as many:
    the program's counters (``utils/profiling.py:count``), the specular
    share of the stored vertices, and the ``clive2.*`` spans a sample
    (``benchmark/spans.py:read``), with the launches of every cast kernel
    (the BVH2 kernel only) and the device time of each of the port's own
    kernels a sample.  Prints one JSON line."""
    import shutil

    import torch

    from benchmark import manifest, spans, tracing
    from benchmark.modes.progressive import Session
    from clive2_tpu_torch.testing import check_launches, launch_counters
    from clive2_tpu_torch.utils import profiling

    torch.cuda.reset_peak_memory_stats()
    c = manifest.cell(manifest.load_manifest(ROOT), "dragon.1080p", ROOT)
    traffic = c["traffic"]
    session = Session(c["config"], traffic, seed, "cuda")
    r = session.renderer
    tables = sorted(k for k in ("brute", "bvh2", "wide", "stream",
                                "stream2") if k in session.scene.data)
    n = int(traffic["trace_samples"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        r.run_sample()
    torch.cuda.synchronize()
    untraced_s = (time.perf_counter() - t0) / n
    tracing.warm_profiler()
    profiling.counts()
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    logdir = os.path.join(ROOT, "output", "chip_smoke_traces", "dragon")
    with profiling.trace_to(logdir):
        for _ in range(n):
            r.run_sample()
    counted = profiling.counts()
    ran = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    check_launches("dragon_1080p", ("bvh2",), ran)
    trace_file = os.path.join(logdir, profiling.TRACE_FILE)
    got = spans.read(trace_file)
    # the port's own kernels (every name but PyTorch's at::), by name
    with open(trace_file) as f:
        own = {}
        for e in json.load(f)["traceEvents"]:
            if e.get("cat") == "kernel" and "at::" not in e["name"]:
                k = own.setdefault(e["name"], dict(launches=0, ms=0.0))
                k["launches"] += 1 / n
                k["ms"] += float(e["dur"]) / 1e3 / n
    shutil.rmtree(logdir, ignore_errors=True)
    per = lambda v: v / n
    by_span = {k: dict(count=per(v["count"]), host_ms=1e3 * per(v["host_s"]),
                       device_ms=1e3 * per(v["device_s"]),
                       self_device_ms=1e3 * per(v["self_device_s"]),
                       self_launches=per(v["self_launches"]),
                       idle_ms=1e3 * per(v["idle_s"]))
               for k, v in sorted(got["spans"].items())}
    out = dict(
        scene_tris=session.n_triangles, tables=tables,
        scene_build_s=session.scene_build_s, samples=n,
        untraced_s_per_sample=untraced_s,
        counters={k: per(v) for k, v in counted.items()},
        specular_share=(counted["trace.specular_vertices"]
                        / counted["trace.vertices"]),
        launches={k: per(v) for k, v in ran.items() if v},
        own_kernels=own,
        device_ms_per_sample=1e3 * per(got["device_s"]),
        outside_ms_per_sample=1e3 * per(got["outside_s"]),
        spans=by_span,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(phase="dragon_1080p", **out)
    del session, r
    torch.cuda.empty_cache()
    return out


def dragon_phase_alone() -> int:
    """``--phase dragon_1080p``: that phase alone (the mesh written when
    missing)."""
    import torch

    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.scene import RESOURCE_DIR
    from clive2_tpu_torch.testing import write_assets

    kernels.load()
    write_assets(RESOURCE_DIR)
    dragon_1080p()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


# the RNG's bound (csrc/rng.cu): the integer operations of one threefry2x32
# value (20 rounds of add, rotate and xor, 5 key injections of two adds, the
# two first adds; the float conversion and the counter left out) over the
# H100's integer issue rate, 128 lanes a clock an SM (its 64 INT32 lanes,
# and the FMA pipe's 64, on which an add issues as IMAD) x 132 SMs x 1.98
# GHz; against 4 bytes a value written over HBM_BYTES_S
RNG_OPS = 72
INT32_OPS_S = 132 * 128 * 1.98e9


def rng_sass(library):
    """Per RNG kernel instance in a built library, by ``rng_tag``: its
    SASS instructions and those of the integer classes the hash issues
    (IADD3, IMAD, SHF, LOP3)."""
    out = {}
    for name, code in sass_code(library).items():
        tag = rng_tag(name)
        if tag is None:
            continue
        ops = [ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
               for _, ins in code]
        out[tag] = dict(instructions=len(ops), **{
            k: ops.count(k) for k in ("IADD3", "IMAD", "SHF", "LOP3")})
    return out


def rng_tag(name):
    """An RNG kernel instance (csrc/rng.cu): ``keys``, or a draw by its
    counters (rows given or not) and output (bits, uniform)."""
    if "keys_kernel" in name:
        return "keys"
    m = re.search(r"draw_kernelILb([01])ELb([01])E", name)
    if m is None:
        return None
    return (f"draw {'rows' if m.group(1) == '1' else 'no_rows'} "
            f"{'bits' if m.group(2) == '1' else 'uniform'}")


def rng_kernels_vs_plain(scenes, seed=2**31 + 17):
    """Phase ``rng_kernels_vs_plain``: the RNG calls of one sample of each
    of ``scenes`` ((name, scene)), recorded as the renderer makes them (4
    draws, 15 key derivations; the shading kernel draws its own), each
    replayed through its kernel and its plain version on the same key: bit equality (and of ``random_bits``
    for each draw); each kernel call's CUDA-event time (median of 5) beside
    its bound, the plain version's (one call) and the 19 calls back to
    back (median of 5); ptxas's registers and spills and the SASS counts
    of each instance.  The 4 draws of a two-rank tile mesh's lower band,
    which take rows (``rows=lanes``), are held bit for bit too, untimed.
    Returns the figures by scene."""
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels, rng
    from clive2_tpu_torch.integrator import render

    ms = median_event_ms
    kernel_of = {k: getattr(rng, k) for k in ("fold_in", "split", "uniform")}
    plain_of = dict(fold_in=rng.fold_in_plain, split=rng.split_plain,
                    uniform=rng.uniform_plain)
    resources = ptxas_figures(kernels.ptxas_report("rng.cu"), rng_tag)
    for tag, counts in rng_sass(kernels.library_path()).items():
        resources.setdefault(tag, {})["sass"] = counts

    def record(run):
        """The RNG calls ``run()`` makes, each with a copy of its key and
        tensor arguments."""
        calls = []

        def recorder(fn_name):
            def inner(k, *args, **kw):
                calls.append((fn_name, k.clone(), args, {
                    a: v.clone() if isinstance(v, torch.Tensor) else v
                    for a, v in kw.items()}))
                return kernel_of[fn_name](k, *args, **kw)
            return inner

        for k in kernel_of:
            setattr(rng, k, recorder(k))
        try:
            run()
        finally:
            for k, fn in kernel_of.items():
                setattr(rng, k, fn)
        torch.cuda.synchronize()
        return calls

    def same_bits(fn_name, k, args, kw):
        got = kernel_of[fn_name](k, *args, **kw)
        want = plain_of[fn_name](k, *args, **kw)
        if fn_name != "uniform":
            return got, torch.equal(got, want)
        return got, (torch.equal(got.view(torch.int32),
                                 want.view(torch.int32))
                     and torch.equal(rng.random_bits(k, *args, **kw),
                                     rng.random_bits_plain(k, *args, **kw)))

    out = {}
    for name, scene in scenes:
        r = ct.Renderer(scene, seed=seed, device=scene.device)
        calls = record(r.run_sample)
        del r
        # the lower band of a two-rank tile mesh, rendered on this device:
        # its draws take the rows path (rows=lanes, merged_lanes)
        w, h = scene.pixel_width, scene.pixel_height
        tile_key = rng.fold_in(rng.key(seed, device=scene.device), 0)
        tile_calls = [c for c in record(lambda: render.render_sample(
            tile_key, scene.data, w, h, tile=(h // 2, h - h // 2)))
            if c[3].get("rows") is not None]
        tile_unequal = [i for i, c in enumerate(tile_calls)
                        if not same_bits(*c)[1]]
        torch.cuda.empty_cache()
        rows, values, unequal = [], 0, []
        for i, (fn_name, k, args, kw) in enumerate(calls):
            got, same = same_bits(fn_name, k, args, kw)
            if not same:
                unequal.append(i)
            n = got.numel()
            values += n if fn_name == "uniform" else 0
            kernel_ms = ms(lambda: kernel_of[fn_name](k, *args, **kw), 5)
            bound_ms = max(n * RNG_OPS / INT32_OPS_S,
                           got.element_size() * n / HBM_BYTES_S) * 1e3
            rows.append(dict(call=fn_name, shape=list(got.shape),
                             ms=kernel_ms, bound_ms=bound_ms,
                             plain_ms=ms(lambda: plain_of[fn_name](
                                 k, *args, **kw), 1)))
            del got
        replay = lambda: [kernel_of[f](k, *a, **kw)
                          for f, k, a, kw in calls]
        draws = [x for x in rows if x["call"] == "uniform"]
        bound_ms = max(values * RNG_OPS / INT32_OPS_S,
                       4 * values / HBM_BYTES_S) * 1e3
        figures = dict(
            calls=len(calls), draws=len(draws), values=values,
            bit_equal=not unequal, unequal_calls=unequal,
            tile_rows_draws=len(tile_calls),
            tile_bit_equal=not tile_unequal, tile_unequal_calls=tile_unequal,
            sample_ms=ms(replay, 5), bound_ms=bound_ms,
            bound_by="int32 operations",
            draw_ms=sum(x["ms"] for x in draws),
            keys_ms=sum(x["ms"] for x in rows if x["call"] != "uniform"),
            plain_ms=sum(x["plain_ms"] for x in rows), per_call=rows)
        figures["bound_share"] = bound_ms / figures["sample_ms"]
        out[name] = figures
        del calls, tile_calls
        torch.cuda.empty_cache()
        if (unequal or tile_unequal or len(draws) != 4 or len(rows) != 19
                or figures["tile_rows_draws"] != 4):
            figures.pop("per_call")
            raise AssertionError(f"rng_kernels_vs_plain {name}: {figures}")
    if any(v.get("spill_store_bytes") for v in resources.values()):
        raise AssertionError(f"rng_kernels_vs_plain: a spill: {resources}")
    emit(phase="rng_kernels_vs_plain", resources=resources, **out)
    return dict(resources=resources, **out)


def rng_phase_alone() -> int:
    """``--phase rng_kernels_vs_plain``: that phase alone, on Cornell and
    sponza at 1920x1080 (the mesh written when missing)."""
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.scene import RESOURCE_DIR
    from clive2_tpu_torch.testing import write_assets

    dev = torch.device("cuda")
    kernels.load()
    write_assets(RESOURCE_DIR)
    rng_kernels_vs_plain(
        (("cornell_1080p", ct.create_scene_from_preset(
            "empty", 1920, 1080, device=dev)),
         ("sponza_1080p", ct.create_scene_from_preset(
             "sponza", 1920, 1080, device=dev))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


# the shading's bound (csrc/shade.cu): bytes a lane a bounce, each read
# once and each write once: the ray's 11 fields (76), the hit (16), active,
# from_camera and the pending pdf (6), the triangle row (60); vertex d's 11
# fields (76), the next ray's (76), the pending pdf, stored and active (6)
SHADE_LANE_BYTES = 316
# trace_subpaths's arguments to a shading, in order
SHADE_ARGS = ("keys", "depth", "hit", "cur", "active", "fwd_pending", "fc",
              "lanes", "scene", "vertices", "stored")


def shade_tag(name):
    """A shading kernel instance (csrc/shade.cu) by its rows flag and
    estimator: ``rows``/``no_rows``, then ``reference``, ``corrected depth
    0`` or ``corrected``."""
    m = re.search(r"shade_kernelILb([01])ELb([01])ELb([01])E", name)
    if m is None:
        return None
    rows = "rows" if m.group(1) == "1" else "no_rows"
    if m.group(2) == "1":
        return f"{rows} reference"
    return f"{rows} corrected{' depth 0' if m.group(3) == '1' else ''}"


def nvcc_seconds(sources):
    """Seconds of nvcc for each of ``sources`` (file names in csrc/) alone,
    all started together as ``kernels.build`` starts them."""
    import tempfile

    from clive2_tpu_torch import kernels

    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in sources:
            cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-c", "-o",
                   os.path.join(tmp, src + ".o"),
                   os.path.join(kernels.CSRC, src)]
            procs[src] = (time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        out = {}
        for src, (t0, proc) in procs.items():
            _, err = proc.communicate(timeout=900)
            if proc.returncode:
                raise RuntimeError(f"{src}: nvcc failed: {err.decode()}")
            out[src] = time.perf_counter() - t0
    return out


def shade_kernel_vs_plain(scenes, seed=2**31 + 29):
    """Phase ``shade_kernel_vs_plain``: the six bounces of one sample of each
    of ``scenes`` ((name, scene)) in the renderer's wave order, each
    bounce's inputs copied as ``trace_subpaths`` hands them to the
    shading, each replayed through the kernel (``trace.shade_kernel``) and
    its plain version: the same bits on every output of every lane (a NaN
    equal to any NaN); each one's CUDA-event time (median of 5 calls, the
    inputs restored before each), the six bounces' sums beside the byte
    bound; ptxas's registers and spills of csrc/shade.cu's instances and
    nvcc's seconds for shade.cu and connect.cu alone.  Returns the figures
    by scene."""
    import torch

    from clive2_tpu_torch import kernels, rng
    from clive2_tpu_torch.integrator import render, trace

    resources = ptxas_figures(kernels.ptxas_report("shade.cu"), shade_tag)
    compile_s = nvcc_seconds(("shade.cu", "connect.cu"))
    fields = trace.RAY_FIELDS

    def same_bits(a, b):
        if a.dtype.is_floating_point:
            same = ((a.view(torch.int32) == b.view(torch.int32))
                    | (torch.isnan(a) & torch.isnan(b)))
        else:
            same = a == b
        return same.all(-1) if same.dim() > 1 else same

    def timed(fn, saved, work, reps=5):
        """Median CUDA-event ms of ``fn()`` over ``reps`` calls, ``work``'s
        written tensors restored from ``saved`` before each."""
        times = []
        for _ in range(reps):
            for k, v in saved["cur"].items():
                work["cur"][k].copy_(v)
            work["active"].copy_(saved["active"])
            work["fwd_pending"].copy_(saved["fwd_pending"])
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    out = {}
    for name, scene in scenes:
        w, h = scene.pixel_width, scene.pixel_height
        bounces, kernel = [], trace.shade_kernel

        def keep(*args):
            a = dict(zip(SHADE_ARGS, args))
            bounces.append(dict(
                a, cur={k: v.clone() for k, v in a["cur"].items()},
                active=a["active"].clone(),
                fwd_pending=a["fwd_pending"].clone()))
            return kernel(*args)

        # the wrapper counts its launches on the name trace_subpaths calls
        keep.launches = 0
        trace.shade_kernel = keep
        try:
            render.trace_wavefront(rng.key(seed, scene.device), scene.data,
                                   w, h, order=render._wave_order(scene.data))
        finally:
            trace.shade_kernel = kernel
        torch.cuda.synchronize()
        n = bounces[0]["active"].shape[0]
        rows = []
        for saved in bounces:
            d = saved["depth"]
            outs, ms = {}, {}
            for route, fn in (("kernel", kernel),
                              ("plain", trace.shade_plain)):
                work = dict(saved, cur={k: v.clone() for k, v in
                                        saved["cur"].items()},
                            active=saved["active"].clone(),
                            fwd_pending=saved["fwd_pending"].clone())
                nxt, active, pending = fn(**work)
                outs[route] = dict(
                    {f"next {f}": nxt[f].clone() for f in fields},
                    active=active.clone(), pending=pending.clone(),
                    stored=work["stored"][d].clone(),
                    **{f"vertex {f}": work["vertices"][f][d].clone()
                       for f in fields})
                ms[route] = timed(lambda: fn(**work), saved, work)
            differing = {k: int((~same_bits(x, outs["plain"][k])).sum())
                         for k, x in outs["kernel"].items()}
            rows.append(dict(depth=d, ms=ms["kernel"], plain_ms=ms["plain"],
                             differing={k: v for k, v in differing.items()
                                        if v}))
            del outs
        bound_ms = 6 * n * SHADE_LANE_BYTES / HBM_BYTES_S * 1e3
        sample_ms = sum(x["ms"] for x in rows)
        figures = dict(
            lanes=n, order=render._wave_order(scene.data),
            bit_equal=not any(x["differing"] for x in rows),
            ms=sample_ms, plain_ms=sum(x["plain_ms"] for x in rows),
            bound_ms=bound_ms, bound_by="bytes",
            bound_share=bound_ms / sample_ms, per_bounce=rows)
        out[name] = figures
        del bounces
        torch.cuda.empty_cache()
        if not figures["bit_equal"] or len(rows) != 6:
            raise AssertionError(f"shade_kernel_vs_plain {name}: {figures}")
    if any(v.get("spill_store_bytes") for v in resources.values()):
        raise AssertionError(f"shade_kernel_vs_plain: a spill: {resources}")
    emit(phase="shade_kernel_vs_plain", resources=resources,
         nvcc_seconds=compile_s, **out)
    return dict(resources=resources, nvcc_seconds=compile_s, **out)


def shade_phase_alone() -> int:
    """``--phase shade_kernel_vs_plain``: that phase alone, on Cornell and
    sponza at 1920x1080 (the mesh written when missing)."""
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.scene import RESOURCE_DIR
    from clive2_tpu_torch.testing import write_assets

    dev = torch.device("cuda")
    kernels.load()
    write_assets(RESOURCE_DIR)
    shade_kernel_vs_plain(
        (("cornell_1080p", ct.create_scene_from_preset(
            "empty", 1920, 1080, device=dev)),
         ("sponza_1080p", ct.create_scene_from_preset(
             "sponza", 1920, 1080, device=dev))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


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
    binning, the leaf test, the second walk, and the tail.  Each kernel is
    timed over ``states`` fresh copies of its input state, its plain step
    once.  Returns {part: dict(ms, plain_ms, bytes, ops, ...)} and the
    round's live rays and tiles."""
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

    # the leaf test against the plain step, on the same (kernel-binned)
    # queue
    def same_best(a, b):
        if not (torch.equal(a.bt, b.bt) and torch.equal(a.bc, b.bc)):
            raise AssertionError(f"{label}: leaf test differs")

    pos, f_all = s2.queue_positions(binned)
    touched = torch.unique(f_all)
    fs = tables["fat_start"].long()
    leaf_bytes = (pos.numel() * (4 + 64 + 8 + 8)
                  + 80 * int((fs[touched + 1] - fs[touched]).sum()))
    tested = run("leaf", lambda st: s2.leaf_test(st, tables),
                 lambda st: s2.leaf_test_plain(st, tables), binned,
                 leaf_bytes, same_best)

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
    return parts, dict(live_after_walk=live, tiles=tiles)


def stream2_variant(c, data, tail_min=None, steps=None, per_thread=False):
    """Cast ``c`` through the queued fat-leaf traversal with a tail size or
    steps class of its own (the A/Bs), or through the per-thread kernel
    whole.  Returns (outputs, dict(rounds, tail_rays)
    or None)."""
    from clive2_tpu_torch.ops import traverse_stream2 as s2

    rays, tables, out = s2.kernel_args(c["origin"], c["direction"], data,
                                       c["active"], c["t_max"])
    if per_thread:
        s2.stream2_thread(rays, tables, c["any_hit"], out)
        return out, None
    stats = s2.queued_cast(
        (rays.origin, rays.direction, rays.active, rays.t_max),
        (steps or s2.KernelSteps)(tables, c["any_hit"]), out,
        tail_min=s2.TAIL_MIN if tail_min is None else tail_min)
    return out, dict(zip(("rounds", "tail_rays"), stats))


def stream2_breakdown(c, data):
    """Where one queued fat-leaf cast's time goes: CUDA events around each
    step (walk; the binning's count, plan and scatter kernels; leaf test;
    tail, which runs on a side stream beside the next chunk's rounds),
    summed by step and by round over the chunks, beside the host clock
    around the whole cast.  Then the count kernel's library call,
    ``torch.bincount``, on each round's own input (kept during the cast,
    timed after it), held to the kernel's histogram."""
    import torch

    from clive2_tpu_torch.ops import traverse_stream2 as s2

    events, rounds, count_inputs = [], [0], []

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
            count_inputs.append((st.leaf.clone(), st.hist.clone()))
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
    # bincount of the fat-leaf ids shifted by one, so that -1 (no fat leaf)
    # falls into bin 0 (the shift made before the timing); one warm-up
    n_fat = data["stream2"]["fat_start"].numel() - 1
    bincount_ms = []
    for leaf, hist in count_inputs:
        shifted = leaf + 1
        lib_ms, lib = cuda_time(
            lambda: torch.bincount(shifted, minlength=n_fat + 1), 1)
        if not torch.equal(lib[1:].int(), hist):
            raise AssertionError("stream2_breakdown: bincount differs from "
                                 "the count kernel")
        bincount_ms.append(lib_ms)
    del count_inputs
    return dict(wall_ms=wall, steps_ms=ms, calls=calls,
                main_stream_ms_by_round=by_round,
                main_stream_idle_ms=wall - sum(by_round.values()),
                count_library=dict(
                    call="torch.bincount", ms=sum(bincount_ms),
                    count_kernel_ms=ms["count"], rounds=len(bincount_ms),
                    ms_by_round=bincount_ms),
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
    from clive2_tpu_torch.ops import (brute, intersect, packet_walk,
                                      traverse_bvh2, traverse_stream,
                                      traverse_stream2, traverse_wide)
    from clive2_tpu_torch.ops.intersect import WORK
    from clive2_tpu_torch.scene import PACKERS
    from clive2_tpu_torch.testing import leaf_tie_winner, tie_soup

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
    # the persistent traversal kernels', the brute kernel's and the packet
    # walk's resources: ptxas's report (registers, shared memory, spills),
    # what the runtime reports (resident blocks; for the packet walk, per
    # instance, from ptxas's figures), and their SASS instruction counts
    for name, src, module in (("bvh2", "traverse_bvh2.cu", traverse_bvh2),
                              ("stream", "traverse_stream.cu",
                               traverse_stream),
                              ("wide", "traverse_wide.cu", traverse_wide),
                              ("brute", "brute.cu", None),
                              ("packet_walk", "packet_walk.cu", None)):
        ptxas = kernels.ptxas_report(src)
        instances = None
        if name == "packet_walk":
            instances = ptxas_figures(ptxas, packet_tag)
            for tag, f in instances.items():
                f["resident_blocks"] = resident_blocks(
                    f["registers"], f["static_smem_bytes"],
                    1024 if "[1024]" in tag else 32)
        emit(phase=f"{name}_resources",
             ptxas=[ln.strip() for ln in ptxas.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln],
             runtime=None if module is None else {
                 "any_hit" if a else "closest": module.kernel_info(any_hit=a)
                 for a in (False, True)}, instances=instances)
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
    # the hand-built edges of the test, each against both edge triangles
    from clive2_tpu_torch.testing import brute_edge_cases

    eo, ed, etris = (torch.from_numpy(x).to(dev) for x in brute_edge_cases())
    for k in range(etris.shape[0]):
        got = brute.intersect_brute(eo, ed, etris[k:k + 1])
        compare_hits(got, brute.brute_plain(eo, ed, etris[k:k + 1]),
                     f"brute edge cases, triangle {k}")
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
    from clive2_tpu_torch.scene import RESOURCE_DIR
    from clive2_tpu_torch.testing import write_assets

    assets = write_assets(RESOURCE_DIR)
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
    # the packet walk on the tie soup: inside a leaf the larger id of a tied
    # pair wins (testing.leaf_tie_winner); the kernel equals its plain
    # version on the first 2^12 rays
    packet_ties = {}
    for packet, group in packet_walk.SIZES:
        kw = dict(packet=packet, group=group)
        t, ids = packet_walk.packet_walk(*tie_rays, ties["bvh2"], **kw)
        want = leaf_tie_winner(rows["leaf_packed"], ids.cpu().numpy())
        same = want >= 0
        if not (ids.cpu().numpy()[same] == want[same]).all():
            raise AssertionError(f"packet walk [{packet}] tie soup: a tie "
                                 "inside a leaf went to the smaller id")
        few = tuple(x[:1 << 12] for x in tie_rays)
        pt, pi = packet_walk.packet_walk_plain(*few, ties["bvh2"], **kw)
        if not (torch.equal(pt, t[:1 << 12]) and torch.equal(pi,
                                                              ids[:1 << 12])):
            raise AssertionError(f"packet walk [{packet}] tie soup: the "
                                 "kernel differs from its plain version")
        packet_ties[packet] = int(same.sum())
    if tie_hits < 10_000:
        raise AssertionError(f"tie soup: only {tie_hits} hits")
    torch.cuda.synchronize()
    emit(phase="kernel_bvh2_vs_plain", checks=checks, scene_tris=
         teapots.n_triangles, scene_build_s=build_s,
         tie_soup=dict(tris=10_000, rays=1 << 18, hits=tie_hits,
                       lower_slot_wins=True,
                       packet_walk_same_leaf_ties=packet_ties),
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

    timing, bounds, compared = {}, {}, {}
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
            emit(phase="main_path_cast", kernel=name, cast=shapes[rays],
                 rays=rays, any_hit=c["any_hit"],
                 active=rays if c["active"] is None else int(c["active"].sum()),
                 capped=c["t_max"] is not None, ms=ms, plain_ms=plain_ms,
                 mrays_s=rays / ms / 1e3, plain_mrays_s=rays / plain_ms / 1e3,
                 bound_ms=bounds[name, shapes[rays]][0],
                 bound_by=bounds[name, shapes[rays]][1],
                 bound_share=bounds[name, shapes[rays]][0] / ms, work=work,
                 max_abs_err_t=e, matches_plain=True)
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
                # the per-thread kernel and other tail sizes, on the same
                # cast: all equal the default's ids
                for key, kw in (("per_thread", dict(per_thread=True)),
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
                parts, round_ = stream2_parts(head, scene.data["stream2"],
                                              label)
                parts_of[sname, shapes[rays]] = parts
                emit(phase="kernel_stream2_parts_vs_plain", scene=sname,
                     cast=shapes[rays], rays=rays,
                     chunk_rays=head["origin"].shape[0],
                     parts={k: dict(v, bound_ms=bound(v["bytes"],
                                                      v["ops"])[0])
                            for k, v in parts.items()},
                     **round_, equal=True)
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

    # ---- 5b. the connection's kernels against their plain versions -------
    connect_figures = connect_kernels_vs_plain(
        (("cornell_1080p", cornell, 1920, 1080),
         ("sponza_1080p", sponza, 1920, 1080)))
    # ---- 5c. the RNG's kernels against their plain versions ---------------
    rng_figures = rng_kernels_vs_plain((("cornell_1080p", cornell),
                                        ("sponza_1080p", sponza)))
    # ---- 5d. the trace's shading kernel against its plain version ----------
    shade_figures = shade_kernel_vs_plain((("cornell_1080p", cornell),
                                           ("sponza_1080p", sponza)))

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

    def drive(label, kernel, run, compared=()):
        """``run()`` with the launch counts from 0; fails when a kernel of
        ``kernel`` never ran, a plain version ran (but those of
        ``compared``), or another kernel ran.  Returns the counts."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        run()
        torch.cuda.synchronize()
        ran = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        check_launches(label, kernel, ran, compared)
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

    # ---- 7a. big-dragon (871,422 mesh triangles) at bench.py's size -------
    # 512x512, 4 spp, seed 0 (bench.py:381-383).  First its default route,
    # the queued fat-leaf traversal (its 524,288-ray extension casts, under
    # QUEUE_MIN, on the per-thread kernel), then BVH2 tables under
    # CLIVE2_TRAVERSAL=pallas2, each driven with the launch counts from 0:
    # s/sample, Mrays/s, peak memory, scene build, table bytes and launches
    # by kernel.  Then one extension cast and the connection cast of a
    # sample held to the plain walk on every k-th ray (k the least stride
    # that leaves at most 2^20 rays), and the queued connection cast's
    # breakdown with its count's library call.  The two routes' images:
    # the 4-sample raw images compared pixel by pixel (a figure: the
    # fat-leaf test rounds Möller-Trumbore otherwise than BVH2, so near
    # ties and the paths after them differ), and sample 0 of each rendered
    # again with its casts logged (testing.CastLog), which must agree within
    # rtol 1e-3 on at least 99% of the pixels that no differing cast
    # reaches, those pixels at most 6.5% of the image (about 3x the 2.1% of
    # the card's first runs, NVIDIA H100 80GB HBM3, 700 W: 767 differing
    # rays, every other pixel within rtol 1e-3).
    from clive2_tpu_torch.testing import CastLog

    big_imgs, logs = {}, {}
    for name, env, kernel, table in (
            ("big_dragon_512", {}, queued + ("stream2_thread",), "stream2"),
            ("big_dragon_512_bvh2_ab", dict(CLIVE2_TRAVERSAL="pallas2"),
             ("bvh2",), "bvh2")):
        with environment(**env):
            big, build_s, bvh_s = build_timed("big-dragon", 512, 512, dev)
        got = sorted(set(big.data) & set(PACKERS))
        if got != [table]:
            raise AssertionError(f"{name}: expected the {table} tables, "
                                 f"got {got}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = ct.Renderer(big, seed=0, device=dev)
        times, rays = [], []

        def four_samples():
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.run_sample()
                r.block()
                times.append(time.perf_counter() - t0)
                rays.append(int(r.last_n_rays))

        ran = drive(name, kernel, four_samples)
        big_peak = torch.cuda.max_memory_allocated()
        big_imgs[name] = r.raw_image
        image_ok(name, big_imgs[name])
        if not env:
            for k, v in ran.items():
                launches[k] += v
        r = ct.Renderer(big, seed=0, device=dev)
        with CastLog() as log:
            r.run_sample()
            r.block()
        logs[name] = (log, r.raw_image)
        del r
        figures = dict(
            width=512, height=512, spp=4, order=wave_order(big.data),
            scene_tris=big.n_triangles, scene_build_s=build_s,
            bvh_build_s=bvh_s, table=table,
            table_bytes=table_bytes(big.data[table]), s_per_sample=times,
            mrays_s=sum(rays) / sum(times) / 1e6, rays=sum(rays),
            peak_gib=big_peak / 2**30,
            peak_over_base_gib=(big_peak - base) / 2**30,
            counts=ran, image_mean=float(big_imgs[name].mean()))
        if env:
            a, b = big_imgs["big_dragon_512"], big_imgs[name]
            close = np.isclose(a, b, rtol=1e-3, atol=1e-6).all(-1)
            (log_a, one_a), (log_b, one_b) = logs["big_dragon_512"], logs[name]
            near, differing = log_a.near(log_b, 0, 512, 512)
            one = np.isclose(one_a, one_b, rtol=1e-3, atol=1e-6).all(-1)
            figures["routes_agree"] = dict(
                rtol=1e-3, atol=1e-6, four_samples=dict(
                    pixels_close=float(close.mean()),
                    mean_rel_diff=float(abs(a.mean() - b.mean()) / a.mean())),
                sample_0=dict(
                    differing_rays=differing,
                    near_tie_share=float(near.mean()),
                    pixels_close=float(one.mean()),
                    pixels_close_outside_near_ties=float(one[~near].mean())))
            del logs

        n = 512 * 512
        module = traverse_stream2 if table == "stream2" else traverse_bvh2
        casts = record_casts(module, f"intersect_{table}",
                             ct.Renderer(big, seed=1, device=dev))
        if sorted(casts) != [2 * n, 36 * n]:
            raise AssertionError(f"{name}: casts of {sorted(casts)} rays")
        if table == "stream2":
            tables = big.data["stream2"]
            plain = plains["stream2"]
        else:
            tables = {k: big.data["bvh2"][k] for k in ("nodes", "tris")}

            def plain(c, data):
                return intersect.intersect_bvh_packed(
                    c["origin"], c["direction"], data["bvh"],
                    active=c["active"], t_max=c["t_max"])
        held = {}
        for rays_n, c in sorted(casts.items()):
            cast = "extension" if rays_n == 2 * n else "connection"
            key = err_key(table, c)
            held[cast] = held_cast(
                f"{key} {name} {cast}", c,
                lambda c: launch(table, c, big.data),
                lambda c: plain(c, big.data), tables,
                stride=-(-rays_n // (1 << 20)))
            held[cast]["kernel"] = key
            err[key] = max(err[key], held[cast]["max_abs_err_t"])
            emit(phase="bvh2_ab_cast" if env else "main_path_cast",
                 scene="big_dragon", cast=cast, **held[cast])
        if table == "stream2":
            emit(phase="stream2_breakdown", scene="big_dragon",
                 cast="connection", rays=36 * n,
                 **stream2_breakdown(casts[36 * n], big.data))
            # per sample: the per-thread kernel's casts, and the casts that
            # took the queue
            held["extension"]["launches"] = ran["stream2_thread"] // 4
            held["connection"]["launches"] = (
                ran["stream2"] - ran["stream2_thread"]) // 4
            extra_casts["stream2_thread", "big_dragon_extension"] = dict(
                held["extension"], cast="big_dragon_512 extension")
            extra_casts["stream2", "big_dragon_connection"] = dict(
                held["connection"], cast="big_dragon_512 connection")
        else:
            held["connection"]["launches"] = ran["bvh2"] // 4
            extra_casts["bvh2", "big_dragon_bvh2_ab_connection"] = dict(
                held["connection"], cast="big_dragon_512 connection on "
                "BVH2 tables (CLIVE2_TRAVERSAL=pallas2)")
        emit(phase=name, casts=held, **figures)
        del big, casts, c
        torch.cuda.empty_cache()
        agree_0 = env and figures["routes_agree"]["sample_0"]
        if agree_0 and (agree_0["pixels_close_outside_near_ties"] < 0.99
                        or agree_0["near_tie_share"] > 0.065):
            raise AssertionError(f"big-dragon: the two routes' images "
                                 f"disagree: {figures['routes_agree']}")
    del big_imgs

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

    # the convergence oracles' per-strategy images are the connection's
    # plain versions (connect_paths(debug_per_strategy=True))
    from clive2_tpu_torch.testing import CONNECT_PLAIN
    ran = drive("oracles", ("brute",), run_oracles, compared=CONNECT_PLAIN)
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

    # ---- 7f. the tools of scripts/ that ran TPU kernels -------------------
    # kernel_stats and kernel_microbench (the packet walk) and link_probe,
    # each driven through its own entry point with the launch counts from
    # 0, then each kernel held to its plain version on the inputs the tool
    # gave it
    from clive2_tpu_torch.ops import link_probe as probe_kernel
    from clive2_tpu_torch.ops import mosaic_probes
    from clive2_tpu_torch.scripts import (kernel_microbench, kernel_stats,
                                          launch_cost, link_probe,
                                          probe_mosaic_layouts)
    from clive2_tpu_torch.scripts.kernel_microbench import graph_ms

    def quiet(line):
        pass

    def held_packets(label, c, tables, packet, group, variant, count,
                     kernel_ms=None):
        """The packet walk on cast ``c``: the kernel (timed as the
        microbench times it, unless its time is given, and from a CUDA
        graph) against one call of the plain version, counts, t and ids
        equal on every packet and ray; the figures, with the bound from the
        plain call's work and the pops per packet, mean and most (the
        longest packets may set the launch's time)."""
        kw = dict(tables=tables, packet=packet, group=group,
                  variant=variant, count=count)
        ms, got = kernel_microbench.timed(
            lambda: packet_walk.packet_walk(**c, **kw), dev)
        g_ms = graph_ms(lambda: packet_walk.packet_walk(**c, **kw))
        stats = (got if count else packet_walk.packet_walk(
            **c, **dict(kw, count=True)))[2]
        n = c["origin"].shape[0]
        packets = packet_walk.packet_count(n, packet)
        plain_ms, want, work = plain_time(
            lambda: packet_walk.packet_walk_plain(**c, **kw))
        for what, a, b in zip(("t", "ids", "counts"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"{label}: {what} differ from the "
                                     f"plain version on {bad} rows")
        nbytes = (n * (12 + 12 + 1 + 4 + 4 + 4) + 12 * packets * count
                  + table_bytes({k: tables[k] for k in ("nodes", "tris")}))
        b_ms, b_by = bound(nbytes, work_ops(work))
        pops = stats[:, 0].double()
        return dict(rays=n, active=kernel_stats.active_rays(c),
                    packets=packets, packet=packet, group=group,
                    variant=variant, ms=kernel_ms or ms, graph_ms=g_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_share=b_ms / (kernel_ms or ms),
                    graph_bound_share=b_ms / g_ms,
                    pops_per_packet=float(pops.mean()),
                    max_pops_per_packet=int(pops.max()), matches_plain=True)

    tools = {}
    t0 = time.perf_counter()
    dragon_b = ct.create_scene_from_preset("dragon", 512, 512, device=dev)
    stats_rows = {}
    for name, scene in (("teapots_512", teapots), ("dragon_512", dragon_b)):
        t1 = time.perf_counter()
        records = []
        ran = drive(f"packet_stats {name}", ("packet_walk", "bvh2"),
                    lambda: records.extend(kernel_stats.run(scene,
                                                            out=quiet)))
        tables = scene.data["bvh2"]
        for r in records:
            key = (name, r["population"], r["packet"])
            stats_rows[key] = held_packets(
                f"packet_stats {' '.join(map(str, key))}", r["cast"],
                tables, r["packet"], r["group"], packet_walk.COUNTING, True)
            stats_rows[key]["report"] = r["figures"]
        emit(phase="packet_stats", scene=name, scene_tris=scene.n_triangles,
             seconds=time.perf_counter() - t1, launches=ran,
             casts={f"{p} [{k}]": v for (n_, p, k), v in stats_rows.items()
                    if n_ == name})
        tools.setdefault("packet_stats", {}).update(
            {name: ran["packet_walk"]})
    del dragon_b

    t1 = time.perf_counter()
    bench = {}
    ran = drive("packet_ablation teapots_512", ("packet_walk", "bvh2"),
                lambda: bench.update(zip(("cast", "records", "bvh2"),
                                         kernel_microbench.run(teapots,
                                                               out=quiet))))
    ablation = {}
    for r in bench["records"]:
        key = f"{r['variant']} [{r['packet']}]"
        ablation[key] = held_packets(
            f"packet_ablation {key}", bench["cast"], teapots.data["bvh2"],
            r["packet"], r["group"], r["variant"], False, kernel_ms=r["ms"])
        ablation[key].update(mrays_s=r["mrays_s"],
                             us_per_packet=r["us_per_packet"])
    # why a mean of 5 back-to-back calls misread the BVH2 kernel on this
    # cast: the card's time over the 5, the host's time to issue them and
    # the caching allocator's cudaMalloc calls among them, as the cache
    # stands and after torch.cuda.empty_cache()
    cast = bench["cast"]

    def bvh2_cast():
        return traverse_bvh2.intersect_bvh2(
            cast["origin"], cast["direction"], {"bvh2": teapots.data["bvh2"]},
            active=cast["active"], t_max=cast["t_max"])

    def back_to_back(n=5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        t1 = time.perf_counter()
        start.record()
        for _ in range(n):
            bvh2_cast()
        end.record()
        host_ms = (time.perf_counter() - t1) * 1e3 / n
        torch.cuda.synchronize()
        return dict(mean_ms=start.elapsed_time(end) / n,
                    host_ms_per_call=host_ms,
                    cuda_mallocs=torch.cuda.memory_stats().get(
                        "segment.all.allocated", 0) - mallocs)

    bvh2_cast()
    back_to_back_ms = {"cache_as_is": back_to_back()}
    torch.cuda.empty_cache()
    back_to_back_ms["after_empty_cache"] = back_to_back()
    emit(phase="packet_ablation", scene="teapots_512",
         seconds=time.perf_counter() - t1, launches=ran,
         cast="connection casts (t=2,s=2), Morton-sorted",
         variants=ablation, bvh2_kernel_same_cast=bench["bvh2"],
         bvh2_back_to_back=back_to_back_ms)
    tools["packet_ablation"] = ran["packet_walk"]

    t1 = time.perf_counter()
    probe_rows = []
    ran = drive("link_probe", ("link_probe",),
                lambda: probe_rows.extend(link_probe.probe(dev,
                                                           out=quiet)[1]))
    a = torch.randn(link_probe.SHAPE, generator=gen, device=dev) * 1e3
    a.view(-1)[:4] = torch.tensor([0.0, -0.0, float("inf"), 3e38],
                                  device=dev)
    ms, got = cuda_time(lambda: probe_kernel.scale_shift(a), 20)
    plain_ms, want = cuda_time(lambda: probe_kernel.scale_shift_plain(a), 20)
    one, two = torch.ones((), device=dev), torch.full((), 2.0, device=dev)
    lib_ms, lib = cuda_time(lambda: torch.addcmul(one, a, two), 20)
    if not (torch.equal(got, want) and torch.equal(lib, want)):
        raise AssertionError("link probe kernel: not a * 2 + 1 bit for bit")
    b_ms, b_by = bound(2 * a.numel() * 4, 2 * a.numel())
    # ms: the mean of 20 wrapper calls, their host path included; graph_ms:
    # the card's time alone, per call of 20 replayed from a CUDA graph;
    # host_us: host µs per launch over 2,000 back-to-back calls, the median
    # of 3 rounds in turns (clive2_tpu_torch/scripts/launch_cost.py times
    # it in full)
    calls = {"torch.addcmul": lambda: torch.addcmul(one, a, two),
             "link_probe wrapper": lambda: probe_kernel.scale_shift(a)}
    host = {k: [] for k in calls}
    for r in range(3):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            torch.cuda.synchronize()
            host[k].append(launch_cost.per_call_us(calls[k], 2000))
    torch.cuda.synchronize()
    probe_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by, bit_equal=True,
                     graph_ms=graph_ms(
                         lambda: probe_kernel.scale_shift(a)),
                     library_graph_ms=graph_ms(
                         lambda: torch.addcmul(one, a, two)),
                     host_us={k: sorted(v)[1] for k, v in host.items()})
    emit(phase="link_probe", rows=probe_rows,
         verdict=link_probe.verdict(probe_rows),
         launches=ran, kernel=probe_row, seconds=time.perf_counter() - t1,
         tools_seconds=time.perf_counter() - t0)
    tools["link_probe"] = ran["link_probe"]

    # the layout probes (probe_mosaic_layouts): the tool through its entry
    # point, which holds each kernel to its plain version (its records keep
    # the output and the largest error); then each kernel timed on the
    # tool's inputs, beside its plain version and one PyTorch call, each
    # the median of 5 single launches (ms: the wrapper's host path
    # included) and per call of GRAPH_CALLS replayed from a CUDA graph
    # (graph_ms: the card's time alone)
    t1 = time.perf_counter()
    probe_lines, probes = [], []
    ran = drive("mosaic_probes", ("slab_copy", "matmul_t", "matmul"),
                lambda: probes.extend(probe_mosaic_layouts.run(
                    dev, out=probe_lines.append)),
                compared=("slab_copy_plain", "matmul_t_plain",
                          "matmul_plain"))
    if not all(r["ok"] for r in probes):
        raise AssertionError(f"mosaic_probes: {probe_lines}")
    tools["mosaic_probes"] = ran

    def timed(fn):
        return kernel_microbench.timed(fn, dev)

    mosaic, in_turns = {}, {}
    for r in probes:
        kernel, args, got = r["kernel"], r["args"], r["out"]
        fn = getattr(mosaic_probes, kernel)
        plain = getattr(mosaic_probes, f"{kernel}_plain")
        ms = timed(lambda: fn(*args))[0]
        plain_ms, want = timed(lambda: plain(*args))
        row = dict(shapes=[list(a.shape) for a in args], ms=ms,
                   plain_ms=plain_ms, max_abs_err=r["max_abs_err"],
                   graph_ms=graph_ms(lambda: fn(*args)),
                   plain_graph_ms=graph_ms(lambda: plain(*args)))
        if kernel == "slab_copy":
            x, = args
            row["bands"] = mosaic_probes.bands(*x.shape[1:])
            lib_ms, lib = timed(lambda: x[2, :8, :128].float())
            # bound_ms: the function's own bytes, its window read as bf16
            # and written as f32; slab_bound_ms: the whole slab read, which
            # is what the probe moves (slab_gb_s its rate)
            slab = 2 * x[2].numel()
            b_ms, b_by = bound(6 * got.numel(), 0)
            slab_ms = bound(slab + 4 * got.numel(), 0)[0]
            row.update(library_ms=lib_ms,
                       library_call="x[2, :8, :128].float()",
                       library_graph_ms=graph_ms(
                           lambda: x[2, :8, :128].float()),
                       library_max_abs_err=float((lib - want).abs().max()),
                       slab_bytes=slab, slab_bound_ms=slab_ms,
                       slab_graph_bound_share=slab_ms / row["graph_ms"],
                       slab_gb_s=slab / row["graph_ms"] / 1e6)
        else:
            a, b = args
            lhs = a.t() if kernel == "matmul_t" else a
            diff = (got - want).abs()
            scale = mosaic_probes.abs_product(a, b, kernel == "matmul_t")
            # the library call: torch.mm on the bf16 operands with an f32
            # output where this PyTorch has out_dtype, else on the f32
            # casts (TF32 off); both timed where both exist
            f32 = (lambda lhs=lhs, b=b: torch.mm(lhs.float(), b.float()),
                   "torch.mm on the f32 casts, TF32 off")
            bf16 = (lambda lhs=lhs, b=b: torch.mm(lhs, b,
                                                  out_dtype=torch.float32),
                    "torch.mm(bf16, bf16, out_dtype=torch.float32)")
            row["mm_f32_ms"], lib = timed(f32[0])
            libs, call = {"mm_f32": lib}, f32
            try:
                row["mm_bf16_ms"], libs["mm_bf16"] = timed(bf16[0])
                call = bf16
            except (TypeError, RuntimeError) as e:     # no out_dtype
                row["mm_bf16_note"] = f"{type(e).__name__}: {e}"[:200]
            b_ms, b_by = bound(2 * (a.numel() + b.numel()) + 4 * got.numel(),
                               2 * lhs.shape[0] * lhs.shape[1] * b.shape[1],
                               BF16_TC_FLOPS_S)
            row.update(
                err_over_abs_product=float((diff / scale)[scale > 0].max()),
                library_ms=row["mm_bf16_ms" if call is bf16 else "mm_f32_ms"],
                library_call=call[1], library_graph_ms=graph_ms(call[0]),
                library_max_abs_err={k: float((v - want).abs().max())
                                     for k, v in libs.items()})
            in_turns[f"{r['tag']} kernel"] = lambda fn=fn, a=a, b=b: fn(a, b)
            in_turns[f"{r['tag']} library"] = call[0]
        row.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                   graph_bound_share=b_ms / row["graph_ms"])
        mosaic[r["tag"]] = row
    # a K-major A against a row-major one on the same product: dot128's
    # A stored transposed through matmul_t, in turns with matmul, each
    # from a CUDA graph
    a, b = probes[-1]["args"]
    a_k = a.t().contiguous()
    k_major, outs = {"row_major_graph_ms": [], "k_major_graph_ms": []}, {}
    for name, fn in (("row_major", lambda: mosaic_probes.matmul(a, b)),
                     ("k_major", lambda: mosaic_probes.matmul_t(a_k, b)),
                     ("k_major", lambda: mosaic_probes.matmul_t(a_k, b)),
                     ("row_major", lambda: mosaic_probes.matmul(a, b))):
        outs[name] = fn()
        k_major[f"{name}_graph_ms"].append(graph_ms(fn))
    if not bool(((outs["k_major"] - mosaic_probes.matmul_plain(a, b)).abs()
                 <= mosaic_probes.REL * mosaic_probes.abs_product(a, b)
                 ).all()):
        raise AssertionError("mosaic_probes: the K-major product is off its "
                             "plain version past 2^-14 |A|ᵀ|B|")
    k_major.update(shape="[640, 128] @ [128, 128]",
                   bit_equal=torch.equal(outs["row_major"], outs["k_major"]))
    # the product kernel as built: ptxas's figures per instance, the tile
    # and grid of each product, and the tile widths and epilogues tried
    tile = mosaic_probes.TILE
    resources = ptxas_figures(kernels.ptxas_report("mosaic_probes.cu"),
                              mma_tag)
    records = {r["tag"]: r for r in probes}
    # dynamic_smem_bytes: what the entry asks for at this K, B's rows
    design = {tag: dict(resources[kernel], tile=[tile["m"], tile["n"]],
                        grid=[records[tag]["out"].shape[1] // tile["n"],
                              records[tag]["out"].shape[0] // tile["m"]],
                        dynamic_smem_bytes=mosaic_probes.smem_bytes(
                            records[tag]["args"][1].shape[0]))
              for tag, kernel in (("dotT", "matmul_t"), ("dot128", "matmul"))}
    # the two products and their library calls again in turns (forward,
    # reversed, twice), each from a CUDA graph: the ratios from the medians
    # of 4 (the upper one), which one reading of each is too noisy to settle
    turns = {name: [] for name in in_turns}
    for keys in (list(turns), list(turns)[::-1]) * 2:
        for name in keys:
            turns[name].append(graph_ms(in_turns[name]))
    med = {name: sorted(v)[len(v) // 2] for name, v in turns.items()}
    for tag in ("dotT", "dot128"):
        design[tag]["graph_over_library"] = (med[f"{tag} kernel"]
                                             / med[f"{tag} library"])
    design.update(turns_graph_ms=turns, dot128_over_dotT=med["dot128 kernel"]
                  / med["dotT kernel"])
    emit(phase="mosaic_probes", lines=probe_lines, launches=ran,
         probes=mosaic, k_major_ab=k_major, product_kernel=design,
         tiles_tried=MMA_TILES_TRIED, seconds=time.perf_counter() - t1,
         tools_seconds=time.perf_counter() - t0)

    # ---- 7g. the tools that drive the renderer ------------------------------
    # Each of clive2_tpu_torch/scripts/ as a subprocess, as a user runs it,
    # on the card: make_assets into a temporary directory (its bytes
    # against resources/, which phase 4 wrote with the same generator),
    # smoke_render at 128x128 and 4 spp (the verify skill's Cornell band at
    # 1:1), profile_stages on teapots 512 and big-dragon 512 (2 reps),
    # parity_render under both estimators (one process each, as the
    # estimator flag is read at import) and its --report, and
    # movie_launcher with 2 workers, 4 frames at 160x90 and 1 spp.  A
    # nonzero exit fails the run.
    import signal
    import tempfile

    work = os.path.join(ROOT, "output", "chip_smoke", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def tool(name, *args, timeout=600, **env):
        """``python -m clive2_tpu_torch.scripts.<name> args`` in ``work``;
        returns (stdout, seconds).  Raises on a nonzero exit, and kills the
        tool and its workers past ``timeout``."""
        t0 = time.perf_counter()
        env = dict(os.environ, **env)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        p = subprocess.Popen(
            [sys.executable, "-m", f"clive2_tpu_torch.scripts.{name}",
             *args], cwd=work, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            out, errs = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
            raise AssertionError(f"{name} {args}: over {timeout} s")
        if p.returncode:
            raise AssertionError(f"{name} {args} exited {p.returncode}:\n"
                                 f"{out[-3000:]}\n{errs[-3000:]}")
        return out, time.perf_counter() - t0

    def last_json(out):
        return json.loads(out.strip().splitlines()[-1])

    tools_run = {}
    res = tempfile.mkdtemp(dir=work)
    out, sec = tool("make_assets", CLIVE2_RESOURCES=res)
    same = {}
    for name in sorted(os.listdir(res)):
        with open(os.path.join(res, name), "rb") as a, \
                open(os.path.join(RESOURCE_DIR, name), "rb") as b:
            same[name] = a.read() == b.read()
    tools_run["make_assets"] = dict(rc=0, seconds=sec,
                                    lines=out.strip().splitlines(),
                                    bytes_equal_resources=same)
    if len(same) != 5 or not all(same.values()):
        raise AssertionError(f"make_assets: {same}")
    shutil.rmtree(res)

    out, sec = tool("smoke_render", "--size=128", "--spp=4")
    stats = re.search(r"raw image stats: min (\S+) mean (\S+) max (\S+)",
                      out)
    raw_mean = float(stats.group(2))
    pngs = sorted(os.listdir(os.path.join(work, "output")))
    tools_run["smoke_render"] = dict(rc=0, seconds=sec,
                                     lines=out.strip().splitlines(),
                                     raw_mean=raw_mean, pngs=pngs)
    if pngs != ["smoke_bdpt.png", "smoke_uni.png"]:
        raise AssertionError(f"smoke_render wrote {pngs}")
    # the verify skill's health band for the Cornell preset at 1:1
    if not 0.0055 <= raw_mean <= 0.0065:
        raise AssertionError(f"smoke_render: Cornell raw mean {raw_mean} "
                             "outside the 1:1 band 0.0055-0.0065")

    profiles = {}
    for preset in ("teapots", "big-dragon"):
        out, sec = tool("profile_stages", preset, "512", "2")
        profiles[preset] = dict(last_json(out), rc=0, seconds=sec)
    tools_run["profile_stages"] = profiles

    parity = {}
    for tag, flag in (("production", "0"), ("refmis", "1")):
        out, sec = tool("parity_render", CLIVE2_REFERENCE_MIS=flag)
        parity[tag] = dict(json.loads(out.strip().splitlines()[-1]), rc=0,
                           seconds=sec)
    out, sec = tool("parity_render", "--report")
    parity["report"], end = json.JSONDecoder().raw_decode(out)
    parity["vs_tpu"] = json.loads(out[end:])
    parity["report_seconds"] = sec
    tools_run["parity_render"] = parity
    # bands of the raw mean, about 3% around the card's first run
    # (NVIDIA H100 80GB HBM3, 700 W: 0.012349 and 0.013299; the JAX
    # package's TPU renders in docs/images read 0.012541 and 0.013420)
    for tag, lo, hi in (("production", 0.0120, 0.0127),
                        ("refmis", 0.0129, 0.0137)):
        if parity[tag]["nan"] or not lo <= parity[tag]["raw_mean"] <= hi:
            raise AssertionError(f"parity_render {tag}: raw mean outside "
                                 f"{lo}-{hi}, or NaN: {parity[tag]}")

    movies = os.path.join(work, "movies")
    out, sec = tool("movie_launcher", "--workers", "2", "--",
                    "--width", "160", "--height", "90", "--samples", "1",
                    "--movie-frames", "4", "--output-dir", movies)
    frames = sorted(os.listdir(os.path.join(movies, "test-movie")))
    tools_run["movie_launcher"] = dict(
        rc=0, seconds=sec, frames=frames,
        launches=[ln for ln in out.splitlines() if ln.startswith("launch:")])
    if frames != [f"frame_{i:04d}.png" for i in range(4)]:
        raise AssertionError(f"movie_launcher wrote {frames}")

    # the diagnostics: diag_mis on Cornell 32x32, key 7, DIAG_MIS_SPP
    # samples under the default estimator (mis_gate), then
    # DIAG_MIS_REF_SPP under CLIVE2_REFERENCE_MIS=1 in a process of its
    # own (recorded: which classes the reference's estimator misses);
    # shade_ab at 2x512x512 and 2x1920x1080 rays, 20 reps each, and its
    # all_lobes on the card held to the CPU on the card's inputs
    # (shade_gate); shadow_cache_study on dragon 512 (BVH2) and sponza
    # 1080p (the queued fat-leaf traversal), 3 samples each: exactly one
    # connection cast a sample, finite counts, cache hits within the
    # occluded casts and the disagreements
    from clive2_tpu_torch.scripts import shade_ab

    out, sec = tool("diag_mis", str(DIAG_MIS_SPP), "32")
    mis = dict(last_json(out), seconds=sec)
    mis["failures"] = mis_gate(mis)
    out, sec = tool("diag_mis", str(DIAG_MIS_REF_SPP), "32",
                    CLIVE2_REFERENCE_MIS="1")
    mis_ref = dict(last_json(out), seconds=sec)
    mis_ref["sum_ratios"] = {k: c["sum_ratio"] for k, c in
                             mis_ref["classes"].items()}
    tools_run["diag_mis"] = dict(production=mis, refmis=mis_ref)
    if mis["failures"] or not mis_ref["reference_mis"] or \
            mis_ref["n_strategies"] != 41:
        emit(phase="tools", **tools_run)
        raise AssertionError(f"diag_mis: {mis['failures']}")

    shade = {}
    for n in (2 * 512 * 512, 2 * 1920 * 1080):
        out, sec = tool("shade_ab", str(n), "20")
        shade[str(n)] = dict(last_json(out), seconds=sec,
                             lines=out.strip().splitlines()[:-1])
    shade["card_vs_cpu"], bad = shade_gate(
        shade_ab.make_inputs(2 * 512 * 512, 0, dev), shade_ab)
    tools_run["shade_ab"] = shade
    if bad:
        emit(phase="tools", **tools_run)
        raise AssertionError(f"shade_ab: the card against the CPU: {bad}")

    study = {}
    for preset, w, h in (("dragon", 512, 512), ("sponza", 1920, 1080)):
        out, sec = tool("shadow_cache_study", preset, str(w), str(h), "3")
        fig = dict(last_json(out), seconds=sec)
        study[f"{preset}_{w}x{h}"] = fig
        rows = fig["transitions"]
        if fig["casts_recorded"] != [1, 1, 1] or len(rows) != 2 or any(
                not 0 <= r["cache_hit"] <= r["occluded"] + r["disagreements"]
                or not 0 < r["occluded"] <= r["active"]
                <= fig["casts_per_sample"] or not r["cast_ms"] > 0
                for r in rows):
            emit(phase="tools", **tools_run, shadow_cache_study=study)
            raise AssertionError(f"shadow_cache_study {preset}: {fig}")
    tools_run["shadow_cache_study"] = study
    emit(phase="tools", **tools_run)
    shutil.rmtree(os.path.join(ROOT, "output", "chip_smoke"),
                  ignore_errors=True)

    # ---- 7c. the glass dragon cell's counters and spans ---------------------
    dragon_1080p()

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
            ("stream2_leaf", "leaf", "stream2_queue.cu"),
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
    # the tools of scripts/ (phase 7f): each row's launches are its tool's
    # run's; max_abs_err 0: every compared count, t and id equal
    no_walk_call = "no PyTorch call computes a packet walk"
    head = stats_rows["teapots_512", "connection casts (t=2,s=2)", 1024]
    full = ablation["full [1024]"]
    rows += [
        dict(name="packet_walk_counting", route="cuda",
             source="clive2_tpu_torch/csrc/packet_walk.cu",
             replaces="scripts/kernel_stats.py:31",
             launches=sum(tools["packet_stats"].values()), max_abs_err=0.0,
             **{k: head[k] for k in ("ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
             library_ms=None, library_note=no_walk_call,
             cast="teapots 512 connection casts, 1,024-ray packets",
             casts={" ".join(map(str, k)): {
                 f: v[f] for f in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                   "max_pops_per_packet")}
                 for k, v in stats_rows.items()}),
        dict(name="packet_walk_variants", route="cuda",
             source="clive2_tpu_torch/csrc/packet_walk.cu",
             replaces="scripts/kernel_microbench.py:38",
             launches=tools["packet_ablation"], max_abs_err=0.0,
             **{k: full[k] for k in ("ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
             library_ms=None, library_note=no_walk_call,
             cast="teapots 512 connection casts, variant full, 1,024-ray "
                  "packets",
             variants={k: {f: v[f] for f in ("ms", "graph_ms", "plain_ms",
                                             "bound_ms")}
                       for k, v in ablation.items()},
             bvh2_kernel_same_cast_ms=bench["bvh2"]["ms"]),
        dict(name="link_probe", route="cuda",
             source="clive2_tpu_torch/csrc/link_probe.cu",
             replaces="scripts/link_probe.py:84",
             launches=tools["link_probe"], max_abs_err=0.0,
             **{k: probe_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "graph_ms", "library_graph_ms",
                                          "host_us")},
             library_call="torch.addcmul(1, a, 2): a * 2 + 1 in one call",
             cast="f32 [256, 128]")]
    # the layout probes (phase mosaic_probes): the copy's row is dma128's
    # (the largest slab), with every copy under ``probes``; its bound_ms is
    # the window's bytes, slab_bound_ms the slab's
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "graph_ms", "plain_graph_ms",
            "library_graph_ms")
    rows.append(dict(
        name="slab_copy", route="cuda",
        source="clive2_tpu_torch/csrc/mosaic_probes.cu",
        replaces="scripts/probe_mosaic_layouts.py:41",
        launches=tools["mosaic_probes"]["slab_copy"],
        max_abs_err=mosaic["dma128"]["max_abs_err"],
        slab_bound_ms=mosaic["dma128"]["slab_bound_ms"],
        **{k: mosaic["dma128"][k] for k in keys},
        cast="bf16 [4, 640, 128], slab 2 (dma128)",
        probes={tag: mosaic[tag] for tag in ("dma64", "dma128", "dmaT")}))
    for name, tag, line, cast in (
            ("matmul_t", "dotT", 70, "bf16 [64, 640]ᵀ @ [64, 128] (dotT)"),
            ("matmul", "dot128", 85, "bf16 [640, 128] @ [128, 128] (dot128)")):
        rows.append(dict(
            name=name, route="cuda",
            source="clive2_tpu_torch/csrc/mosaic_probes.cu",
            replaces=f"scripts/probe_mosaic_layouts.py:{line}",
            launches=tools["mosaic_probes"][name],
            max_abs_err=mosaic[tag]["max_abs_err"],
            **{k: mosaic[tag][k] for k in keys},
            cast=cast,
            err_over_abs_product=mosaic[tag]["err_over_abs_product"]))
    # each traversal's casts in raster, Morton wave and Morton-key order
    for name, cell in (("bvh2", "teapots_512"), ("wide", "dragon_512_wide"),
                       ("stream2", "sponza_1080p"),
                       ("stream", "sponza_1080p_stream1")):
        next(row for row in rows if row["name"] == name)["wave_order"] = dict(
            cell=cell, casts=wave[cell]["casts"])
    # the connection's kernels: sponza 1080p's sample (phase
    # connect_kernels_vs_plain); they replace no TPU kernel
    for name in ("rays", "shade"):
        rows.append(dict(
            name=f"connect_{name}", route="cuda",
            source="clive2_tpu_torch/csrc/connect.cu",
            replaces="none: clive2_tpu/integrator/connect.py is XLA-fused "
                     "jnp",
            launches=launches[f"connect_{name}"],
            **connect_figures["sponza_1080p"][name],
            cast="sponza 1920x1080, one sample's 2,073,600 lanes"))
    # the RNG's kernels: sponza 1080p's sample (phase rng_kernels_vs_plain);
    # they replace no TPU kernel
    sponza_rng = rng_figures["sponza_1080p"]
    for name, draw, ms_key in (("rng_uniform", True, "draw_ms"),
                               ("rng_keys", False, "keys_ms")):
        per = [x for x in sponza_rng["per_call"]
               if (x["call"] == "uniform") == draw]
        rows.append(dict(
            name=name, route="cuda", source="clive2_tpu_torch/csrc/rng.cu",
            replaces="none: jax.random's threefry is XLA-fused",
            launches=launches[name], bit_equal=sponza_rng["bit_equal"],
            ms=sponza_rng[ms_key],
            bound_ms=sum(x["bound_ms"] for x in per),
            bound_by="int32 operations",
            plain_ms=sum(x["plain_ms"] for x in per),
            cast=f"sponza 1920x1080, one sample's {len(per)} calls"))
    # the trace's shading kernel: sponza 1080p's sample (phase
    # shade_kernel_vs_plain); it replaces no TPU kernel
    sponza_shade = shade_figures["sponza_1080p"]
    rows.append(dict(
        name="trace_shade", route="cuda",
        source="clive2_tpu_torch/csrc/shade.cu",
        replaces="none: clive2_tpu/integrator/trace.py is XLA-fused jnp",
        launches=launches["trace_shade"],
        bit_equal=sponza_shade["bit_equal"],
        **{k: sponza_shade[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bound_share")},
        cast="sponza 1920x1080, one sample's 6 bounces of 4,147,200 lanes"))
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
    alone = {"connect_kernels_vs_plain": connect_phase_alone,
             "dragon_1080p": dragon_phase_alone,
             "rng_kernels_vs_plain": rng_phase_alone,
             "shade_kernel_vs_plain": shade_phase_alone}
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" and (
            sys.argv[2] in alone):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(alone[sys.argv[2]]())
    try:
        code = main()
    except Exception as e:                 # report the phase that failed
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
