"""Micro-A/B of the packet walk's variants on one ray population (the
counterpart of the JAX package's scripts/kernel_microbench.py).

The variants (ops/packet_walk.py:VARIANTS: the same walk with pieces
ablated) are timed on the t=2, s=2 connection casts of one sample of a
preset, Morton-sorted, in packets of 1,024 rays (groups of 128, the TPU's
packet) and of 32 (one warp):

  full         the TPU kernel's walk: nearer child first by the packet's
               least entry distance
  noleaf       no leaf tested (node phase only; t = t_max, id -1 on every
               ray: timing only)
  nogroupskip  a visited leaf tested by every group, hit or not
  noorder      no near-first ordering (A always popped first)
  noreduce     "hit" by any instead of a min reduction (A first)

On the card each variant's time is the median of 5 single launches after
a warm-up, each between its own CUDA events after a synchronise, beside the production per-ray BVH2 kernel
(ops/traverse_bvh2.py:intersect_bvh2) on the same sorted cast, the design
the packet walk would have to beat.  With ``--device cpu`` one call of the
plain version is timed on the host clock (a CPU figure, not the card's).

    python -m clive2_tpu_torch.scripts.kernel_microbench [preset] [size]
        [variants...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.packet_walk import SIZES, VARIANTS, packet_count, packet_walk
from ..ops.traverse_bvh2 import intersect_bvh2
from .. import create_scene_from_preset
from .kernel_stats import (active_rays, bvh2_tables, populations,
                           resolve_device, sort_cast)

CAST = "connection casts (t=2,s=2)"
ITERS = 5


def timed(fn, device, iters: int = ITERS):
    """(milliseconds, output) of ``fn``: on the card the median of ``iters``
    single calls after one warm-up, each between its own CUDA events after
    a synchronise, so that a call the host is slow to issue delays only
    itself (a mean of back-to-back calls puts the card's wait on the host
    into every sub-millisecond launch); on the CPU one call on the host
    clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out
    out = fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2], out


GRAPH_CALLS = 20


def graph_ms(fn):
    """Device milliseconds per call of ``fn`` with no host path between the
    calls: GRAPH_CALLS calls captured in one CUDA graph, its replay timed
    as ``timed`` times a call (median of 5 after a warm-up), over
    GRAPH_CALLS.  ``fn`` has run before (lazy set-up stays out of the
    capture)."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(GRAPH_CALLS):
            fn()
    return timed(g.replay, torch.device("cuda"))[0] / GRAPH_CALLS


def line(name, ms, n_active, n_packets):
    return (f"  {name:12s} {ms:8.2f} ms  {n_active / ms / 1e3:7.2f} Mrays/s"
            f"  {ms * 1e3 / n_packets:8.3f} us/packet")


def run(scene, names=None, out=print):
    """Each variant of ``names`` (all when None) at each packet size on the
    scene's sorted connection cast, and on the card the BVH2 kernel on the
    same cast.  Returns (the sorted cast, one record per (variant, size)
    with its ms, Mrays/s, µs per packet and outputs, and the BVH2 kernel's
    record or None)."""
    names = list(names or VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}: expected some of "
                         f"{', '.join(VARIANTS)}")
    tables = bvh2_tables(scene)
    cast = sort_cast(populations(scene)[CAST], tables)
    n_active = active_rays(cast)
    where = "card" if scene.device.type == "cuda" else "cpu, plain version"
    records = []
    for packet, group in SIZES:
        n_packets = packet_count(cast["origin"].shape[0], packet)
        out(f"{scene.pixel_width}x{scene.pixel_height} ({where}): "
            f"{n_packets} packets of {packet} rays, "
            f"{n_active / 1e6:.2f}M active cast rays")
        for name in names:
            ms, hits = timed(lambda: packet_walk(
                **cast, tables=tables, packet=packet, group=group,
                variant=name), scene.device)
            out(line(name, ms, n_active, n_packets))
            records.append(dict(variant=name, packet=packet, group=group,
                                ms=ms, mrays_s=n_active / ms / 1e3,
                                us_per_packet=ms * 1e3 / n_packets,
                                t=hits[0], id=hits[1]))
    yardstick = None
    if scene.device.type == "cuda":
        ms, _ = timed(lambda: intersect_bvh2(
            cast["origin"], cast["direction"], {"bvh2": tables},
            active=cast["active"], t_max=cast["t_max"]), scene.device)
        out(f"  {'bvh2 kernel':12s} {ms:8.2f} ms  "
            f"{n_active / ms / 1e3:7.2f} Mrays/s  (per-ray, same cast)")
        yardstick = dict(ms=ms, mrays_s=n_active / ms / 1e3)
    return cast, records, yardstick


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", nargs="?", default="teapots")
    p.add_argument("size", nargs="?", type=int, default=512)
    p.add_argument("variants", nargs="*")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    run(create_scene_from_preset(args.preset, args.size, args.size,
                                 device=device), args.variants or None)


if __name__ == "__main__":
    sys.exit(main())
