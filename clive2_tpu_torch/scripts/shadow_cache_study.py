"""Is a cross-sample shadow-occluder cache worth building?  (The port's
counterpart of the JAX package's scripts/shadow_cache_study.py, with the
same arguments and prints; PAPERS.md: "Hash-Based Ray Path Prediction".)

The candidate: remember, per (strategy, pixel) slot, the triangle that
occluded last sample's connection cast; next sample, test that one
triangle first and mark the ray occluded (inactive for the traversal) if
it still blocks.  The win is about the fraction of casts skipped, and it
depends on how far BDPT's connection endpoints move between samples (both
resample every sample).  This renders K consecutive samples of a preset
with ``connect.cast_connections`` (stage A's one batched cast) recorded,
and reports per sample transition:

  occluded      the share of active casts with an occluder (the ceiling)
  cache-hit     the share of active casts whose slot's occluder of the
                sample before still blocks today's ray (a float64
                Möller-Trumbore test, ``occludes``)
  skippable     cache-hit over occluded (the realized share of the ceiling)
  disagreements the cache hits that the float64 test confirms but the cast
                (float32, the kernel's own rounding) called unoccluded

A cache is free of error only if every confirmed hit is an occluded ray;
the JAX script assumes it and checks it with an assert that cannot fire,
so the port counts the disagreements and reports them instead.

Slots are keyed by (strategy, pixel) through each sample's lane -> pixel
map, so that the Morton wave order of the card's BVH scenes compares the
same slots (in raster order lane and pixel are one).  Only the current
sample's cast and the previous sample's occluders by slot are kept, on the
device; the test runs in float64 on the device in chunks.  The triangles'
vertices are the soup ``create_scene_from_preset`` assembles (cast ids
are global soup ids).  The cast's ms are its time on the card between
CUDA events (host clock on the CPU).

    python -m clive2_tpu_torch.scripts.shadow_cache_study [preset] [width]
        [height] [samples] [--device cuda|cpu]

Prints the JAX script's lines, a line of disagreements and cast time per
transition, then one JSON line of the figures.  Runs on the card unless
``--device cpu`` (without a card the default raises).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from ..integrator import connect, render
from ..ops.sampling import cross, dot
from .kernel_stats import resolve_device

DELTA = 1e-4
SEED = 11
CHUNK = 1 << 22


def occludes(verts, tri_ids, o, d, t_max, chunk=CHUNK):
    """[M] bool: does triangle ``tri_ids[i]`` (of ``verts`` [T, 3, 3],
    float64) block ray i strictly inside (DELTA, t_max)?  Möller-Trumbore
    in float64, in chunks of ``chunk`` rays; a NaN (a degenerate triangle)
    and an id below 0 do not occlude."""
    out = torch.empty(tri_ids.shape[0], dtype=torch.bool,
                      device=tri_ids.device)
    for i in range(0, tri_ids.shape[0], chunk):
        ids = tri_ids[i:i + chunk]
        tv = verts[ids.clamp(min=0).long()]
        v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        oc = o[i:i + chunk].double()
        dc = d[i:i + chunk].double()
        h = cross(dc, e2)
        f = 1.0 / dot(e1, h)
        s = oc - v0
        u = f * dot(s, h)
        q = cross(s, e1)
        v = f * dot(dc, q)
        t = f * dot(e2, q)
        out[i:i + chunk] = ((ids >= 0) & (u >= 0) & (u <= 1) & (v >= 0)
                            & (u + v <= 1) & (t > DELTA)
                            & (t < t_max[i:i + chunk]))
    return out


@contextlib.contextmanager
def recorded_casts(casts, pixels):
    """Record each ``connect.cast_connections`` call into ``casts`` (dict
    of its rays [P, N, ...], the cast's tri [P, N] and its ms) and each
    wavefront's lane -> pixel map into ``pixels``, for the length of the
    block."""
    def cast(fn):
        def wrapped(origin, direction, active, t_max, *a, **k):
            cuda = origin.device.type == "cuda"
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            tri, t = fn(origin, direction, active, t_max, *a, **k)
            if cuda:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = 1e3 * (time.perf_counter() - t0)
            casts.append(dict(o=origin, d=direction, active=active,
                              t_max=t_max, tri=tri, ms=ms))
            return tri, t
        return wrapped

    def weights(fn):
        def wrapped(sensor_pos, pixel_idx, *a, **k):
            pixels.append(pixel_idx.long())
            return fn(sensor_pos, pixel_idx, *a, **k)
        return wrapped

    with contextlib.ExitStack() as stack:
        for mod, name, wrap in ((connect, "cast_connections", cast),
                                (render, "filter_weights", weights)):
            orig = getattr(mod, name)
            setattr(mod, name, wrap(orig))
            stack.callback(setattr, mod, name, orig)
        yield


def slot_hits(prev_by_slot, cur, pixel, verts):
    """[P, N] lane-order masks of one sample transition, the current cast
    ``cur`` against the previous sample's occluders by slot [P, W*H]:
    (active, occluded, cache hit)."""
    act = cur["active"] & (cur["t_max"] > 0)
    occ = act & (cur["tri"] >= 0)
    cand = prev_by_slot[:, pixel]          # the slot's occluder, lane order
    hit = act & (cand >= 0) & occludes(
        verts, cand.reshape(-1), cur["o"].reshape(-1, 3),
        cur["d"].reshape(-1, 3), cur["t_max"].reshape(-1)).reshape(act.shape)
    return act, occ, hit


def transition(prev_by_slot, cur, pixel, verts):
    """Counts of one sample transition (``slot_hits``)."""
    act, occ, hit = slot_hits(prev_by_slot, cur, pixel, verts)
    return dict(active=int(act.sum()), occluded=int(occ.sum()),
                cache_hit=int(hit.sum()),
                disagreements=int((hit & ~occ).sum()))


def by_slot(tri, pixel, n_pixels):
    """[P, N] lane-order cast ids as [P, n_pixels] by pixel."""
    out = torch.full((tri.shape[0], n_pixels), -1, dtype=tri.dtype,
                     device=tri.device)
    out[:, pixel] = tri
    return out


def run(preset="dragon", width=64, height=48, samples=3, device="cuda"):
    """Render ``samples`` samples of ``preset`` (seed 11, the JAX
    script's) with the connection cast recorded and print the study;
    returns its figures."""
    import clive2_tpu_torch as ct

    device = resolve_device(device)
    soup = {}

    def keep(s):
        soup["vertices"] = s.vertices
        return s

    scene = ct.create_scene_from_preset(preset, width, height, device=device,
                                        soup_transform=keep)
    verts = torch.as_tensor(soup.pop("vertices"), dtype=torch.float64,
                            device=device)
    r = ct.Renderer(scene, seed=SEED)
    rows, per_sample, cast_ms, prev = [], [], [], None
    for k in range(samples):
        casts, pixels = [], []
        with recorded_casts(casts, pixels):
            r.run_sample()
        per_sample.append(len(casts))
        if len(casts) != 1 or len(pixels) != 1:
            raise AssertionError(f"sample {k}: {len(casts)} connection "
                                 f"casts and {len(pixels)} wavefronts "
                                 "recorded, expected 1")
        cur, pixel = casts[0], pixels[0]
        cast_ms.append(cur["ms"])
        if k == 0:
            print(f"{preset} {width}x{height}, {samples} samples; "
                  f"casts/sample = {cur['tri'].numel()}")
        else:
            c = transition(prev, cur, pixel, verts)
            c.update(sample=f"{k - 1}->{k}", cast_ms=cur["ms"],
                     occluded_pct=100 * c["occluded"] / c["active"],
                     cache_hit_pct=100 * c["cache_hit"] / c["active"],
                     skippable_pct=100 * c["cache_hit"]
                     / max(c["occluded"], 1))
            rows.append(c)
            print(f"sample {k-1}->{k}: active {c['active']}  occluded "
                  f"{c['occluded_pct']:5.1f}%  cache-hit "
                  f"{c['cache_hit_pct']:5.1f}%  (= {c['skippable_pct']:4.1f}"
                  f"% of the occluded ceiling)")
            print(f"  disagreements {c['disagreements']} (confirmed, cast "
                  f"unoccluded); connection cast {cur['ms']:.3f} ms")
        prev = by_slot(cur["tri"], pixel, width * height)
        del casts, cur         # this sample's rays go before the next sample
    figures = dict(
        preset=preset, width=width, height=height, samples=samples,
        seed=SEED, order=render._wave_order(scene.data),
        device=torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu",
        casts_per_sample=int(prev.numel()), casts_recorded=per_sample,
        cast_ms=cast_ms, transitions=rows)
    print(json.dumps(figures), flush=True)
    return figures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", nargs="?", default="dragon")
    p.add_argument("width", nargs="?", type=int, default=64)
    p.add_argument("height", nargs="?", type=int, default=48)
    p.add_argument("samples", nargs="?", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    return run(args.preset, args.width, args.height, args.samples,
               args.device)


if __name__ == "__main__":
    main()
