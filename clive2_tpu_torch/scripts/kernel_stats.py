"""Packet-walk statistics of a preset's ray populations (the counterpart of
the JAX package's scripts/kernel_stats.py).

Runs the counting packet walk (ops/packet_walk.py, variant ``noreduce``)
over the ray populations of one sample of a preset: camera rays, depth-2
bounce rays and the t=2, s=2 connection casts (light depth-1 vertex to
camera depth-1 vertex, capped at d * 1.001 + 1e-4), each sorted by its
Morton key, in packets of 1,024 rays in groups of 128 (the TPU's packet)
and of 32 rays (one warp), and reports per packet the node pops, leaf
visits and group activations: the numbers that decide where the walk's
time goes.

    python -m clive2_tpu_torch.scripts.kernel_stats [preset] [size]
        [--device cuda|cpu]

On the card the walk is the CUDA kernel (csrc/packet_walk.cu); with
``--device cpu`` its plain version.  The preset must be on the BVH2 route
(the JAX package's pallas2 tables): it raises otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import create_scene_from_preset, rng
from ..integrator.trace import (generate_camera_rays, generate_light_rays,
                                trace_subpaths)
from ..ops.intersect import morton_key, ray_order
from ..ops.packet_walk import COUNTING, SIZES, packet_walk
from ..scene import selected_traversal, to_device, traversal_tables


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; raises for CUDA without a card (no
    fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} was asked for, but CUDA is "
                           "not available")
    return device


def bvh2_tables(scene):
    """The scene's BVH2 tables (``nodes``, ``tris``, ``lo``, ``hi``).  A
    scene on the card carries them when it is on the BVH2 route; a scene on
    the CPU carries none (it takes the gather walk), so they are packed
    here when the card would have them.  Raises for a scene off the BVH2
    route, as the JAX tool asserts its ``pallas`` tables."""
    if "bvh2" in scene.data:
        return scene.data["bvh2"]
    n_world = scene.n_triangles - len(scene.camera_tri_ids)
    route = ("brute" if "brute" in scene.data
             else selected_traversal(n_world, cuda=True))
    if scene.device.type != "cpu" or route != "bvh2":
        raise ValueError(f"the scene is not on the BVH2 route (it takes "
                         f"{route}): the packet walk reads the BVH2 tables")
    rows = {k: v.numpy() for k, v in scene.data["bvh"].items()}
    return to_device(traversal_tables(rows, n_world, cuda=True,
                                      traversal="bvh2")["bvh2"],
                     scene.device)


def populations(scene):
    """{name: cast} of the three ray populations of one sample (seed 0,
    as the JAX tool's ``key(0)``), as the JAX tool draws them: camera rays, depth-2 bounce rays
    of the merged camera and light wavefront, and the t=2, s=2 connection
    casts.  A cast is a dict of origin, direction, active and t_max (None
    when every ray is active or uncapped)."""
    w, h = scene.pixel_width, scene.pixel_height
    data = scene.data
    k1, k2, k3 = rng.split(rng.key(0, scene.device), 3)
    cam, _ = generate_camera_rays(k1, data["camera"], w, h)
    n = w * h
    light = generate_light_rays(k2, data["lights"], data["mat"], n)
    merged = {k: torch.cat([cam[k], light[k]]) for k in cam}
    fc = torch.arange(2 * n, device=scene.device) < n
    path = trace_subpaths(k3, merged, data, from_camera=fc)
    v, valid = path["vertices"], path["valid"]
    lv_o, cv_o = v["origin"][1][n:], v["origin"][1][:n]
    delta = cv_o - lv_o
    dist = torch.sqrt(torch.clamp((delta * delta).sum(-1), min=1e-30))
    return {
        "camera rays": dict(origin=cam["origin"], direction=cam["direction"],
                            active=None, t_max=None),
        "depth-2 bounce rays": dict(origin=v["origin"][2],
                                    direction=v["direction"][2],
                                    active=valid[2], t_max=None),
        "connection casts (t=2,s=2)": dict(
            origin=lv_o, direction=delta / dist[:, None],
            active=valid[1][n:] & valid[1][:n], t_max=dist * 1.001 + 1e-4),
    }


def sort_cast(cast, tables):
    """The cast in the order of its rays' Morton keys on the tables' root
    box (the JAX tools' ``_morton_key`` order; inactive rays last)."""
    order = ray_order(morton_key(cast["origin"], cast["direction"],
                                tables["lo"], tables["hi"], cast["active"]))
    return {k: None if x is None else x[order] for k, x in cast.items()}


def active_rays(cast) -> int:
    a = cast["active"]
    return cast["origin"].shape[0] if a is None else int(a.sum())


def packet_stats(origin, direction, tables, active=None, t_max=None,
                 sort=True, packet=1024, group=128):
    """The counting walk's per-packet (node pops, leaf visits, activations)
    [packets, 3] as a numpy array, and the number of packets (the JAX
    tool's ``packet_stats``, at any of the kernel's packet sizes)."""
    cast = dict(origin=origin, direction=direction, active=active,
                t_max=t_max)
    if sort:
        cast = sort_cast(cast, tables)
    _, _, stats = packet_walk(**cast, tables=tables, packet=packet,
                              group=group, variant=COUNTING, count=True)
    return stats.cpu().numpy(), stats.shape[0]


def report(name, stats, n_packets, n_active, packet=1024, group=128,
           out=print):
    """The JAX tool's report lines (kernel_stats.py:236-243) at ``packet``
    rays in groups of ``group``; returns the figures."""
    pops, leaves, groups = (int(x) for x in stats.sum(axis=0))
    fig = dict(packets=n_packets, active_rays=n_active,
               pops_per_packet=pops / n_packets,
               leaf_visits_per_packet=leaves / n_packets,
               groups_per_visit=groups / max(leaves, 1),
               groups_per_packet=packet // group,
               leaf_visits_per_ray=leaves * packet / max(n_active, 1))
    out(f"{name}: {n_packets} packets, {n_active/1e6:.2f}M active rays")
    out(f"  node pops / packet: {fig['pops_per_packet']:8.1f}")
    out(f"  leaf visits/packet: {fig['leaf_visits_per_packet']:8.1f}   "
        f"groups-MT/visit: {fig['groups_per_visit']:5.2f} of "
        f"{packet // group}")
    out(f"  leaf visits/ray:    {fig['leaf_visits_per_ray']:8.2f} "
        f"(packet-amortized)")
    return fig


def run(scene, out=print):
    """The report of every population at every packet size; returns one
    record per (population, size): its name, packet, group, the sorted
    cast the walk took, the counts and the figures."""
    tables = bvh2_tables(scene)
    records = []
    for name, cast in populations(scene).items():
        cast = sort_cast(cast, tables)
        for packet, group in SIZES:
            stats, n_packets = packet_stats(**cast, tables=tables,
                                            sort=False, packet=packet,
                                            group=group)
            fig = report(f"{name} [{packet}-ray packets]", stats, n_packets,
                         active_rays(cast), packet, group, out)
            records.append(dict(population=name, packet=packet, group=group,
                                cast=cast, stats=stats, figures=fig))
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", nargs="?", default="teapots")
    p.add_argument("size", nargs="?", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    run(create_scene_from_preset(args.preset, args.size, args.size,
                                 device=device))


if __name__ == "__main__":
    sys.exit(main())
