"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clive2_tpu_torch/csrc, holds each
against its plain PyTorch version on the card (on synthetic ray sets, then
on the casts the main path itself gives the kernel, recorded from one
sample of each configuration), times both on those casts (and, on the
large scenes' casts, the BVH2 kernel as an A/B to the fat-leaf kernel),
renders the main-path configurations through ``create_scene_from_preset``
-> ``Renderer.run_sample()`` (Cornell ``empty`` at 1920x1080 and ``teapots``
at 512x512 with the brute and BVH2 kernels; ``medium-dragon`` at 512x512 and
``sponza`` at 1920x1080 with the fat-leaf kernel, each followed by the same
render on BVH2 tables as an A/B; 2 samples each) with
launch counters proving the kernels carried every cast, and compares a small
render on the card with the same render on the CPU.  The large meshes are
written into resources/ when missing (procedural stand-ins at the
reference's triangle counts, as scripts/make_assets.py makes them).  Each
phase prints one JSON line; any failure exits non-zero without the final
line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def emit(**kv):
    print(json.dumps(kv), flush=True)


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


def record_casts(module, wrapper, renderer):
    """Run one sample of ``renderer`` with the kernel wrapper
    ``module.<wrapper>`` keeping a copy of the inputs of the first cast of
    each ray count it is given; returns {ray count: inputs}."""
    fn = getattr(module, wrapper)
    casts = {}

    def record(origin, direction, tables, active=None, t_max=None,
               any_hit=False):
        if origin.shape[0] not in casts:
            casts[origin.shape[0]] = dict(
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
        renderer.run_sample()
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


def bvh2_ab_scene(scene):
    """``scene`` with BVH2 tables packed from its gather-walk rows in place
    of its fat-leaf tables (the BVH2 kernel's path), or the reason
    ``pack_bvh2`` refused the tree."""
    import dataclasses

    import torch

    from clive2_tpu_torch.ops.traverse_bvh2 import pack_bvh2

    rows = scene.data["bvh"]
    try:
        tables = pack_bvh2(rows["node_packed"].cpu().numpy(),
                           rows["leaf_packed"].cpu().numpy())
    except ValueError as e:
        return str(e)
    data = {k: v for k, v in scene.data.items() if k != "stream2"}
    data["bvh2"] = {k: torch.from_numpy(v).to(scene.device)
                    for k, v in tables.items()}
    return dataclasses.replace(scene, data=data)


def write_assets(resource_dir):
    """Write the large meshes the presets read when they are missing:
    procedural stand-ins at the reference's triangle counts, with the
    transform of scripts/make_assets.py.  Returns {file: seconds or None
    when the file was there}."""
    import numpy as np

    from clive2_tpu_torch.load import write_ply
    from clive2_tpu_torch.models import displaced_blob_exact

    out = {}
    for name, count in (("dragon_vrip_res2.ply", 202_520),
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
                                      traverse_stream2)

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

    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {"brute": 0.0, "bvh2": 0.0, "stream2": 0.0}

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
    checks = 0
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
         max_abs_err_t=err["brute"], ids_equal=True)

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
    checks = 0
    for rname, (o, d) in sets.items():
        n = o.shape[0]
        active = torch.rand(n, generator=gen, device=dev) < 0.8
        want = intersect.intersect_bvh_packed(o, d, teapots.data["bvh"],
                                              active=active)
        got = traverse_bvh2.intersect_bvh2(o, d, teapots.data, active=active)
        e = compare_hits(got, want, f"bvh2 {rname} closest")
        err["bvh2"] = max(err["bvh2"], e)
        # visibility casts: any-hit under a finite cap
        t_max = torch.rand(n, generator=gen, device=dev) * 12
        want = intersect.intersect_bvh_packed(o, d, teapots.data["bvh"],
                                              active=active, t_max=t_max)
        got = traverse_bvh2.intersect_bvh2(o, d, teapots.data, active=active,
                                           t_max=t_max, any_hit=True)
        compare_hits(got, want, f"bvh2 {rname} any-hit", closest=False)
        checks += 2
    torch.cuda.synchronize()
    emit(phase="kernel_bvh2_vs_plain", checks=checks, scene_tris=
         teapots.n_triangles, scene_build_s=build_s,
         max_abs_err_t=err["bvh2"], ids_equal=True, any_hit_verdicts_equal=True)

    # ---- 4b. the fat-leaf kernel vs its plain version -----------------------
    from clive2_tpu_torch.bvh import native

    assets = write_assets(RESOURCE_DIR)
    dragon, build_s, bvh_s = build_timed("medium-dragon", 512, 512, dev)
    if "stream2" not in dragon.data or "bvh2" in dragon.data:
        raise AssertionError("medium-dragon did not take the stream2 tables")
    s2_tables = dragon.data["stream2"]
    emit(phase="assets", written_s=assets,
         native_bvh=native.available(),
         scene="medium-dragon", scene_tris=dragon.n_triangles,
         scene_build_s=build_s, bvh_build_s=bvh_s,
         fat_leaves=s2_tables["fat_start"].numel() - 1,
         top_nodes=s2_tables["childs"].shape[0])
    cam_d = generate_camera_rays(rng.key(9, dev), dragon.data["camera"],
                                 512, 512)[0]
    lo = dragon.data["bvh"]["node_packed"][0, 0:3]
    hi = dragon.data["bvh"]["node_packed"][0, 3:6]
    sets = {
        "coherent": (cam_d["origin"], cam_d["direction"]),
        "incoherent": random_rays(1 << 18, lo, hi, gen, dev),
    }
    checks, hits, any_ids_equal = 0, {}, True
    for rname, (o, d) in sets.items():
        n = o.shape[0]
        active = torch.rand(n, generator=gen, device=dev) < 0.8
        t_max = torch.rand(n, generator=gen, device=dev) * 12
        for variant, kw in (("closest", dict(active=active)),
                            ("any-hit", dict(active=active, t_max=t_max,
                                             any_hit=True))):
            got = traverse_stream2.intersect_stream2(o, d, dragon.data, **kw)
            want = traverse_stream2.stream2_plain(o, d, s2_tables, **kw)
            closest = variant == "closest"
            e = compare_hits(got, want, f"stream2 {rname} {variant}",
                             closest=closest)
            err["stream2"] = max(err["stream2"], e)
            any_ids_equal &= closest or bool(torch.equal(got[0], want[0]))
            hits[f"{rname} {variant}"] = int((want[0] >= 0).sum())
            checks += 1
    torch.cuda.synchronize()
    emit(phase="kernel_stream2_vs_plain", checks=checks, hits=hits,
         max_abs_err_t=err["stream2"], ids_equal=True,
         any_hit_verdicts_equal=True, any_hit_ids_equal=any_ids_equal)

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

    def bvh2_kernel(c):
        return traverse_bvh2.intersect_bvh2(
            c["origin"], c["direction"], teapots.data, active=c["active"],
            t_max=c["t_max"], any_hit=c["any_hit"])

    def bvh2_plain(c):
        return intersect.intersect_bvh_packed(
            c["origin"], c["direction"], teapots.data["bvh"],
            active=c["active"], t_max=c["t_max"])

    timing = {}
    for name, scene, w, h, module, wrapper, kernel_fn, plain_fn in (
            ("brute", cornell, 1920, 1080, brute, "intersect_brute",
             brute_cast(brute.intersect_brute), brute_cast(brute.brute_plain)),
            ("bvh2", teapots, 512, 512, traverse_bvh2, "intersect_bvh2",
             bvh2_kernel, bvh2_plain)):
        casts = record_casts(module, wrapper, ct.Renderer(scene, seed=1,
                                                          device=dev))
        n = w * h
        shapes = {2 * n: "extension", 36 * n: "connection"}
        if sorted(casts) != sorted(shapes):
            raise AssertionError(f"{name}: casts of {sorted(casts)} rays, "
                                 f"expected {sorted(shapes)}")
        for rays, c in sorted(casts.items()):
            ms, got = cuda_time(lambda: kernel_fn(c), 5)
            plain_ms, want = cuda_time(lambda: plain_fn(c), 1)
            label = f"{name} {shapes[rays]} cast"
            e = compare_hits(got, want, label, closest=not c["any_hit"])
            err[name] = max(err[name], e)
            timing[name, shapes[rays]] = (ms, plain_ms)
            emit(phase="main_path_cast", kernel=name, cast=shapes[rays],
                 rays=rays, any_hit=c["any_hit"],
                 active=rays if c["active"] is None else int(c["active"].sum()),
                 capped=c["t_max"] is not None, ms=ms, plain_ms=plain_ms,
                 mrays_s=rays / ms / 1e3, plain_mrays_s=rays / plain_ms / 1e3,
                 max_abs_err_t=e, matches_plain=True)
            del got, want
        del casts, c
    torch.cuda.empty_cache()

    # ---- 5b. the fat-leaf kernel on the large scenes' own casts ----------
    # One sample of medium-dragon 512x512 and of sponza 1920x1080 runs with
    # the wrapper recording its casts.  The kernel is timed over 5 launches
    # on each whole cast, and the output of that full-size launch is held
    # against the plain walk (one host sync per step, run once) on every
    # k-th ray, k the least stride that leaves at most 2^20 rays: the whole
    # extension cast at 512x512, a sample spread over the whole cast
    # elsewhere.  The BVH2 kernel, with tables packed for this A/B from the
    # same gather-walk rows, is timed on the whole casts and its agreement
    # with the fat-leaf kernel reported.
    sponza, build_s, bvh_s = build_timed("sponza", 1920, 1080, dev)
    emit(phase="scene", name="sponza", scene_tris=sponza.n_triangles,
         scene_build_s=build_s, bvh_build_s=bvh_s,
         fat_leaves=sponza.data["stream2"]["fat_start"].numel() - 1,
         top_nodes=sponza.data["stream2"]["childs"].shape[0])
    ab_scenes = {}
    for sname, scene, w, h in (("medium_dragon", dragon, 512, 512),
                               ("sponza", sponza, 1920, 1080)):
        ab_scenes[sname] = ab_scene = bvh2_ab_scene(scene)
        casts = record_casts(traverse_stream2, "intersect_stream2",
                             ct.Renderer(scene, seed=1, device=dev))
        n = w * h
        shapes = {2 * n: "extension", 36 * n: "connection"}
        if sorted(casts) != sorted(shapes):
            raise AssertionError(f"stream2 {sname}: casts of {sorted(casts)} "
                                 f"rays, expected {sorted(shapes)}")
        for rays, c in sorted(casts.items()):
            ms, got = cuda_time(lambda: traverse_stream2.intersect_stream2(
                c["origin"], c["direction"], scene.data, active=c["active"],
                t_max=c["t_max"], any_hit=c["any_hit"]), 5)
            stride = -(-rays // (1 << 20))
            part = strided(c, stride)
            plain_ms, want = cuda_time(lambda: traverse_stream2.stream2_plain(
                part["origin"], part["direction"], scene.data["stream2"],
                active=part["active"], t_max=part["t_max"],
                any_hit=c["any_hit"]), 1)
            got_part = tuple(x[::stride] for x in got)
            m = part["origin"].shape[0]
            label = f"stream2 {sname} {shapes[rays]} cast"
            e = compare_hits(got_part, want, label, closest=not c["any_hit"])
            err["stream2"] = max(err["stream2"], e)
            timing["stream2", sname, shapes[rays]] = (ms, plain_ms)
            if isinstance(ab_scene, str):
                ab = dict(refused=ab_scene)
            else:
                ab_ms, ab_out = cuda_time(lambda: traverse_bvh2.intersect_bvh2(
                    c["origin"], c["direction"], ab_scene.data,
                    active=c["active"], t_max=c["t_max"],
                    any_hit=c["any_hit"]), 5)
                same = ((ab_out[0] >= 0) == (got[0] >= 0) if c["any_hit"]
                        else ab_out[0] == got[0])
                ab = dict(ms=ab_ms, mrays_s=rays / ab_ms / 1e3,
                          agreement=float(same.float().mean()))
                del ab_out, same
            cap = c["t_max"]
            emit(phase="main_path_cast", kernel="stream2", scene=sname,
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
                 plain_mrays_s=m / plain_ms / 1e3, bvh2_ab=ab,
                 max_abs_err_t=e, matches_plain=True,
                 any_hit_ids_equal=bool(torch.equal(got_part[0], want[0])))
            del got, got_part, want, part
        del casts, c
        torch.cuda.empty_cache()

    # ---- 6./7. the main path at full size ----------------------------------
    counters = {
        "brute": (brute.intersect_brute, "launches"),
        "bvh2": (traverse_bvh2.intersect_bvh2, "launches"),
        "stream2": (traverse_stream2.intersect_stream2, "launches"),
        "brute_plain": (brute.brute_plain, "calls"),
        "gather_walk": (intersect.intersect_bvh_packed, "calls"),
        "stream2_plain": (traverse_stream2.stream2_plain, "calls"),
    }
    plain = ("brute_plain", "gather_walk", "stream2_plain")

    def sponza_scene():                    # built when its slice comes
        scene, build_s, bvh_s = build_timed("sponza", 1920, 1080, dev)
        emit(phase="scene", name="sponza", scene_tris=scene.n_triangles,
             scene_build_s=build_s, bvh_build_s=bvh_s)
        return scene

    # each large slice is followed by its A/B: the same render on the BVH2
    # kernel's tables (the path these scenes took before the fat-leaf
    # kernel), whose launches stay out of the main path's counts
    slices, launches = {}, dict.fromkeys(counters, 0)
    for name, scene, w, h, kernel in (
            ("cornell_1080p", cornell, 1920, 1080, "brute"),
            ("teapots_512", teapots, 512, 512, "bvh2"),
            ("medium_dragon_512", dragon, 512, 512, "stream2"),
            ("medium_dragon_512_bvh2_ab", ab_scenes["medium_dragon"], 512,
             512, "bvh2"),
            ("sponza_1080p", sponza, 1920, 1080, "stream2"),
            ("sponza_1080p_bvh2_ab", ab_scenes["sponza"], 1920, 1080,
             "bvh2")):
        ab = name.endswith("_ab")
        if isinstance(scene, str):
            emit(phase="slice_ab", name=name, refused=scene)
            continue
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
            height=h, spp=2, s_per_sample=times,
            mrays_s=rays / sum(times) / 1e6, rays=rays, counts=ran,
            image_mean=float(img.mean()),
            finite=bool(np.isfinite(img).all()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            scene_tris=scene.n_triangles)
        emit(**slices[name])
        if ran[kernel] <= 0:
            raise AssertionError(f"{name}: the {kernel} kernel never ran")
        if any(ran[k] for k in plain):
            raise AssertionError(f"{name}: a plain version ran: {ran}")
        other = {"stream2": "bvh2", "bvh2": "stream2"}.get(kernel)
        if other and ran[other]:
            raise AssertionError(f"{name}: the {other} kernel ran: {ran}")
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite image")
        if not img.mean() > 0:
            raise AssertionError(f"{name}: the image is black")
        del r, img
    del scene, ab_scenes, sponza
    torch.cuda.empty_cache()
    # the verify skill's health band for the Cornell preset at 16:9 (the
    # mean depends on the aspect ratio: ~0.0058 at 1:1, ~0.0101 at 16:9)
    mean_c = slices["cornell_1080p"]["image_mean"]
    if not 0.0095 <= mean_c <= 0.011:
        raise AssertionError(f"Cornell image mean {mean_c} outside the "
                             "16:9 health band 0.0095-0.011")

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
    # times: brute on Cornell 1080p's connection cast (where its time goes),
    # BVH2 on teapots 512's and the fat-leaf kernel on the medium dragon's
    # extension cast; every cast is in phase 5's lines
    brute_ms = timing["brute", "connection"]
    bvh2_ms = timing["bvh2", "extension"]
    stream2_ms = timing["stream2", "medium_dragon", "extension"]
    print(json.dumps({"kernels": [
        dict(name="brute", route="cuda",
             source="clive2_tpu_torch/csrc/brute.cu",
             replaces="clive2_tpu/ops/brute_pallas.py:29",
             launches=launches["brute"], max_abs_err=err["brute"],
             ms=brute_ms[0], plain_ms=brute_ms[1]),
        dict(name="bvh2", route="cuda",
             source="clive2_tpu_torch/csrc/traverse_bvh2.cu",
             replaces="clive2_tpu/ops/traverse_pallas2.py:144",
             launches=launches["bvh2"], max_abs_err=err["bvh2"],
             ms=bvh2_ms[0], plain_ms=bvh2_ms[1]),
        dict(name="stream2", route="cuda",
             source="clive2_tpu_torch/csrc/traverse_stream2.cu",
             replaces="clive2_tpu/ops/traverse_stream2.py:191",
             launches=launches["stream2"], max_abs_err=err["stream2"],
             ms=stream2_ms[0], plain_ms=stream2_ms[1]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:                 # report the phase that failed
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
