"""Per-stage wall-clock breakdown of one BDPT sample on a preset (the
port's counterpart of the JAX package's scripts/profile_stages.py, with the
same arguments and prints).

    python -m clive2_tpu_torch.scripts.profile_stages [preset] [size] [reps]
        [--device cuda|cpu]

Times four nested prefixes of one sample (``stages``): the merged subpath
trace, + the connection casts (``casts_only``), + the whole
connection (``connect_paths``), the whole ``render_sample``; each after a
warm-up call, ``reps`` calls between two synchronisations of the card.
Prints each prefix's ms, the deltas between them, the rays each stage
casts and the Mrays/s they reach, then one JSON line of the same figures.
Every prefix runs in the sample's own wave order (``_wave_order``: Morton
on the card's BVH scenes), so each is a prefix of the very sample the
renderer runs.  On the card a 512x512 sample is host-bound, and at a few
reps the prefixes' times vary by more than the casts take.  Runs on the
card unless ``--device cpu`` (without a card the default raises).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import constants, rng
from ..constants import MAX_BOUNCES
from ..integrator.connect import (any_hit_casts, cast_connections,
                                  connect_paths, connection_pairs,
                                  connection_rays, specular)
from ..integrator.render import _wave_order, render_sample, trace_wavefront


def casts_only(traced, scene_data):
    """Stage A of ``connect_paths``: its rays (``connection_rays``) through
    its cast (``cast_connections``), with the estimator's any-hit rule and
    the sort policy of ``traced``.  Returns (tri [P, N], t [P, N], active
    [P, N]).  The JAX script maps its cast over the pairs; the port's
    ``connect_paths`` casts them as one batch, and so does this."""
    cam_path, light_path = traced["cam_path"], traced["light_path"]
    mat = scene_data["mat"]
    any_hit = not constants.REFERENCE_MIS and any_hit_casts()
    origin, direction, active, t_max = connection_rays(
        cam_path, light_path, scene_data, connection_pairs(MAX_BOUNCES),
        specular(light_path["vertices"], mat),
        specular(cam_path["vertices"], mat), any_hit)
    tri, t = cast_connections(origin, direction, active, t_max, scene_data,
                              any_hit, traced["connect_sort"])
    return tri, t, active


def stages(scene_data, width, height, order):
    """The four nested prefixes, each a function of the sample's key: the
    merged camera + light trace (``trace_wavefront``: dict(cam_path,
    light_path, n_rays, connect_sort)), + ``casts_only``, + the whole
    ``connect_paths``, the whole ``render_sample``."""
    def trace(key):
        return trace_wavefront(key, scene_data, width, height, order=order)

    def casts(key):
        return casts_only(trace(key), scene_data)

    def connect(key):
        t = trace(key)
        return connect_paths(t["cam_path"], t["light_path"], scene_data,
                             width, height, sort=t["connect_sort"])

    def full(key):
        return render_sample(key, scene_data, width, height, order=order)

    return dict(trace=trace, casts=casts, connect=connect, full=full)


def timeit(fn, key, reps, name, device, counts=None):
    """Seconds per call of ``fn(key)`` over ``reps`` calls after one, each
    run ended by a synchronisation of the card; prints the line."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn(key)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(key)
    sync()
    dt = (time.perf_counter() - t0) / reps
    extra = ""
    if counts is not None:
        extra = f"  ({counts / dt / 1e6:8.2f} Mrays/s for its rays)"
    print(f"{name:28s} {dt * 1e3:9.2f} ms{extra}")
    return dt, out


def run(preset="teapots", size=512, reps=3, device="cuda"):
    """Build ``preset`` at ``size`` x ``size`` on ``device``, time the four
    prefixes with seed 0's key and print them; returns the figures."""
    import clive2_tpu_torch as ct

    device = torch.device(device)
    width = height = size
    scene = ct.create_scene_from_preset(preset, pixel_width=width,
                                        pixel_height=height, device=device)
    key = rng.key(0, device)
    n = width * height
    order = _wave_order(scene.data)
    f = stages(scene.data, width, height, order)

    print(f"preset={preset} {size}x{size}  n={n} rays/wavefront")
    path_rays = int(f["trace"](key)["n_rays"])
    d_tr, _ = timeit(f["trace"], key, reps, "trace_subpaths", device,
                     counts=path_rays)
    d_ca, casts = timeit(f["casts"], key, reps, "trace + casts", device)
    cast_rays = int(casts[2].sum())
    print(f"{'':28s} casts delta {1e3*(d_ca-d_tr):9.2f} ms  "
          f"({cast_rays/1e6:.2f}M active cast rays -> "
          f"{cast_rays/(d_ca-d_tr)/1e6:.2f} Mrays/s)")
    d_cn, _ = timeit(f["connect"], key, reps, "trace + full connect", device)
    print(f"{'':28s} MIS+contrib delta {1e3*(d_cn-d_ca):9.2f} ms")
    d_f, out = timeit(f["full"], key, reps, "full render_sample", device)
    print(f"{'':28s} filter+rest delta {1e3*(d_f-d_cn):9.2f} ms")
    total_rays = int(out["n_rays"])
    print(f"total rays/sample {total_rays/1e6:.2f}M -> "
          f"{total_rays/d_f/1e6:.2f} Mrays/s end-to-end")
    figures = dict(
        preset=preset, size=size, reps=reps, order=order,
        scene_tris=scene.n_triangles,
        device=torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu",
        ms=dict(trace=1e3 * d_tr, trace_casts=1e3 * d_ca,
                trace_connect=1e3 * d_cn, full=1e3 * d_f),
        rays=dict(path=path_rays, active_casts=cast_rays,
                  sample=total_rays),
        mrays_s=dict(path=path_rays / d_tr / 1e6,
                     casts=cast_rays / (d_ca - d_tr) / 1e6,
                     sample=total_rays / d_f / 1e6))
    print(json.dumps(figures), flush=True)
    return figures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", nargs="?", default="teapots")
    p.add_argument("size", nargs="?", type=int, default=512)
    p.add_argument("reps", nargs="?", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(args.preset, args.size, args.reps, args.device)


if __name__ == "__main__":
    main()
