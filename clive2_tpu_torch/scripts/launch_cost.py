"""Host cost of the port's kernel launch path beside one PyTorch op, and
what that cost moves: the link probe's and the slab copy's times and the
seconds a sample takes.

    python3 clive2_tpu_torch/scripts/launch_cost.py [--root DIR]...
        [--out FILE]

Needs a card.  With one root (default: the checkout that holds this file)
it measures that tree's package in this process and prints one JSON line:

  reads       µs per call of each way to read the current stream and the
              current device (READS calls each): what a launch reads
  host_us     µs of host time per launch over LAUNCHES back-to-back calls
              (time.perf_counter_ns, a synchronise before and after and
              outside the time; the card keeps up with them), the median of
              ROUNDS rounds taken in turns: ``torch.addcmul`` on f32
              [256, 128]; the link probe's wrapper on the same array, and
              its parts: ``torch.empty_like``, its C entry called through
              ctypes with the stream read once, ``kernels.call`` with its
              arguments made once; ``kernels.call("clive2_bvh2")`` on one
              ray, its arguments made once; ``intersect_bvh2`` on one ray
  link_probe  the probe kernel's ms (mean of 20 back-to-back wrapper
              calls between CUDA events, as chip_smoke.py times it) and
              graph_ms (per call of 20 replayed from a CUDA graph), beside
              ``torch.addcmul``'s
  slab_copy   each script shape's ms (median of 5 single launches) and
              graph_ms, beside ``x[2, :8, :128].float()``'s
  samples     s/sample of teapots 512x512 and sponza 1920x1080 (the queued
              fat-leaf traversal), after one warm-up sample, each ended by
              a synchronise

The measurement uses only entry points that every tree since the link
probe's port has, so a parent's checkout (``git archive``) can be measured
beside this one.  With several roots it runs each in a subprocess of its
own, in turns (A B B A for two), and prints each run's line; ``--out``
writes them to a file too.  The meshes are written into this checkout's
resources/ when missing (``testing.write_assets``) and every run reads
them there (a lone other root reads ``CLIVE2_RESOURCES`` or its own).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
READS = 10_000
LAUNCHES = 2_000
ROUNDS = 5
SAMPLES = dict(teapots=(512, 512, 5), sponza=(1920, 1080, 3))


def per_call_us(fn, n):
    """Host µs per call of ``fn`` over ``n`` calls in a row."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n / 1e3


def measure(root):
    """Every figure of the module docstring for the package under
    ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import clive2_tpu_torch as ct
    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.ops import link_probe, mosaic_probes, traverse_bvh2
    from clive2_tpu_torch.scripts import probe_mosaic_layouts as tool
    from clive2_tpu_torch.scripts.kernel_microbench import graph_ms, timed

    if not torch.cuda.is_available():
        raise RuntimeError("launch_cost measures on the card: CUDA is not "
                           "available")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = dict(root=os.path.abspath(root), package=ct.__file__,
               device=torch.cuda.get_device_name(0), smi=smi,
               torch=torch.__version__, cuda=torch.version.cuda)

    def sync():
        torch.cuda.synchronize(dev)

    torch.zeros(1, device=dev)           # CUDA's context, before any time
    sync()
    index = dev.index
    reads = {
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
    }
    for fn in reads.values():
        fn()
    out["reads_us"] = {k: per_call_us(fn, READS) for k, fn in reads.items()}

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(256, 128, generator=gen, device=dev)
    one, two = torch.ones((), device=dev), torch.full((), 2.0, device=dev)
    teapots = ct.create_scene_from_preset("teapots", 512, 512, device=dev)
    scene = {"bvh2": teapots.data["bvh2"]}
    o1 = torch.tensor([[0.0, 1.0, 10.0]], device=dev)
    d1 = torch.tensor([[0.0, 0.0, -1.0]], device=dev)
    rays = kernels.ray_args(o1, d1)
    tables = kernels.aligned_tables(scene["bvh2"], traverse_bvh2._TABLES,
                                    dev, "bvh2")
    hits = kernels.hit_outputs(o1)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    ts = (rays.origin, rays.direction, rays.active, rays.t_max)
    bvh2_args = ([t.data_ptr() for t in ts] + [1]
                 + [t.data_ptr() for t in (*tables, counter)] + [0]
                 + [t.data_ptr() for t in hits])
    o = torch.empty_like(a)
    probe_args = (a.data_ptr(), o.data_ptr(), a.numel())
    entry = kernels.load().clive2_link_probe
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = {
        "torch.addcmul": lambda: torch.addcmul(one, a, two),
        "link_probe wrapper": lambda: link_probe.scale_shift(a),
        "torch.empty_like": lambda: torch.empty_like(a),
        "clive2_link_probe entry, stream read once":
            lambda: entry(*probe_args, stream),
        "kernels.call clive2_link_probe":
            lambda: kernels.call("clive2_link_probe", dev, *probe_args),
        "kernels.call clive2_bvh2, 1 ray":
            lambda: kernels.call("clive2_bvh2", dev, *bvh2_args),
        "intersect_bvh2, 1 ray":
            lambda: traverse_bvh2.intersect_bvh2(o1, d1, scene),
    }
    for fn in launch.values():           # builds and loads the kernels
        fn()
    sync()
    rounds = {k: [] for k in launch}
    for r in range(ROUNDS):
        for name in (list(launch) if r % 2 == 0 else list(launch)[::-1]):
            sync()
            rounds[name].append(per_call_us(launch[name], LAUNCHES))
            sync()
    out["host_us"] = {k: dict(median=statistics.median(v), rounds=v)
                      for k, v in rounds.items()}
    out["launches"] = LAUNCHES

    def events_ms(fn, iters=20):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    probe, lib = launch["link_probe wrapper"], launch["torch.addcmul"]
    if not torch.equal(probe(), a * 2.0 + 1.0):
        raise AssertionError("link probe kernel: not a * 2 + 1 bit for bit")
    out["link_probe"] = dict(ms=events_ms(probe), graph_ms=graph_ms(probe),
                             library_ms=events_ms(lib),
                             library_graph_ms=graph_ms(lib))

    out["slab_copy"] = {}
    for tag, kernel, shapes in tool.PROBES:
        if kernel != "slab_copy":
            continue
        x, = tool.inputs(shapes, dev)

        def copy(x=x):
            return mosaic_probes.slab_copy(x)

        def window(x=x):
            return x[2, :8, :128].float()

        if not torch.equal(copy(), mosaic_probes.slab_copy_plain(x)):
            raise AssertionError(f"slab copy {tag}: not bit for bit")
        out["slab_copy"][tag] = dict(
            shape=list(x.shape), ms=timed(copy, dev)[0],
            graph_ms=graph_ms(copy), library_ms=timed(window, dev)[0],
            library_graph_ms=graph_ms(window))

    out["s_per_sample"] = {}
    for preset, (w, h, n) in SAMPLES.items():
        r = ct.Renderer(ct.create_scene_from_preset(preset, w, h,
                                                    device=dev), seed=0)
        r.run_sample()
        sync()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            r.run_sample()
            sync()
            times.append(time.perf_counter() - t0)
        out["s_per_sample"][f"{preset}_{w}x{h}"] = times
        del r
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", action="append",
                   help="a checkout whose package to measure (repeatable; "
                        "default: this one)")
    p.add_argument("--out", help="also write the lines to this file")
    args = p.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.root or [CHECKOUT]]
    if len(roots) > 1 or roots == [CHECKOUT]:
        sys.path.insert(0, CHECKOUT)
        from clive2_tpu_torch.scene import RESOURCE_DIR
        from clive2_tpu_torch.testing import write_assets

        write_assets(RESOURCE_DIR)
        os.environ["CLIVE2_RESOURCES"] = os.path.abspath(RESOURCE_DIR)
    if len(roots) == 1:
        lines = [json.dumps(measure(roots[0]))]
        print(lines[0], flush=True)
    else:
        order = roots + roots[::-1]
        lines = []
        for turn, root in enumerate(order):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root],
                capture_output=True, text=True, timeout=900)
            if proc.returncode:
                raise RuntimeError(f"turn {turn} ({root}) failed:\n"
                                   f"{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            lines.append(json.dumps(dict(rec, turn=turn)))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
