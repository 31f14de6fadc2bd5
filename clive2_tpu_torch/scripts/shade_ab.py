"""Material-sorting A/B of the shading pass (the port's counterpart of the
JAX package's scripts/shade_ab.py, with the same arguments and prints).

The alternative to sorting a wavefront by material is masked evaluation of
every lobe and a select (what ``integrator/trace.py:_select_bounce`` does).
Sorting can only win back the cost difference between all the lobes and
the cheapest one, and this measures that bound:

  all_lobes   diffuse + GGX reflect + GGX transmit + the selects (the
              production pass)
  diffuse     diffuse only (the floor a perfect sort could reach for a
              wavefront that is all diffuse)
  reflect     GGX reflect only (the floor for a wavefront that is all glass)

If 6 x (all_lobes - floor), the six bounces of a sample, is small against
the sample's time, sorting has no headroom whatever its implementation.
The port's bounces are in camera convention (the JAX script passes
``from_camera=True``), so both compute the same thing.

The inputs have the JAX script's distributions (normals and incoming
directions from normals, the incoming direction flipped into the normal's
hemisphere, uniform rolls, a material type uniform in {0, 1, 2}, alpha 0.2,
indices 1 and 1.5), drawn on the device from a ``torch.Generator`` seeded
with 0 (the JAX script draws from key 0).  Each variant's time on the
card is the median of ``reps`` single calls after a warm-up, each between
its own CUDA events (``kernel_microbench.timed``); with ``--device cpu``
one call on the host clock.

    python -m clive2_tpu_torch.scripts.shade_ab [n_rays] [reps]
        [--device cuda|cpu]

Prints the JAX script's line per variant, then one JSON line of the same
figures with the headroom 6 x (all_lobes - the cheaper floor) in ms per
sample.  Runs on the card unless ``--device cpu`` (without a card the
default raises).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..integrator.trace import _select_bounce
from ..ops import bsdf
from ..ops.sampling import dot, ggx_sample, normalize
from .kernel_microbench import timed
from .kernel_stats import resolve_device

DEPTHS = 6


def make_inputs(n, seed=0, device="cpu"):
    """The A/B's inputs for ``n`` rays on ``device``, from a generator
    seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(fn, *shape, **kw):
        return fn(*shape, generator=g, device=device, **kw)

    nrm = normalize(draw(torch.randn, (n, 3)))
    wi = normalize(draw(torch.randn, (n, 3)))
    wi = torch.where(dot(wi, nrm)[:, None] < 0, -wi, wi)
    return dict(nrm=nrm, wi=wi, roll_a=draw(torch.rand, (n, 2)),
                roll_b=draw(torch.rand, (n, 2)), roll_c=draw(torch.rand, (n,)),
                mat_type=draw(torch.randint, 0, 3, (n,), dtype=torch.int32),
                alpha=torch.full((n,), 0.2, device=device),
                ni=torch.ones((n,), device=device),
                no=torch.full((n,), 1.5, device=device))


def all_lobes(x):
    m = ggx_sample(x["nrm"], x["roll_a"], x["alpha"])
    fres = bsdf.fresnel(x["wi"], m, x["ni"], x["no"])
    diffuse = bsdf.diffuse_bounce(x["wi"], x["nrm"], x["roll_b"])
    reflect = bsdf.reflect_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                                  x["alpha"])
    transmit = bsdf.transmit_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                                    x["alpha"])
    return _select_bounce(x["mat_type"], x["roll_c"], fres, diffuse,
                          reflect, transmit)


def diffuse_only(x):
    return bsdf.diffuse_bounce(x["wi"], x["nrm"], x["roll_b"])


def reflect_only(x):
    m = ggx_sample(x["nrm"], x["roll_a"], x["alpha"])
    return bsdf.reflect_bounce(x["wi"], x["nrm"], m, x["ni"], x["no"],
                               x["alpha"])


VARIANTS = dict(all_lobes=all_lobes, diffuse=diffuse_only,
                reflect=reflect_only)


def run(n=2 * 512 * 512, reps=20, device="cuda"):
    """Time the three variants on ``n`` rays; prints the lines and the JSON
    line and returns the figures."""
    device = resolve_device(device)
    x = make_inputs(n, 0, device)
    ms = {}
    for name, fn in VARIANTS.items():
        ms[name] = timed(lambda: fn(x), device, reps)[0]
        print(f"{name:10s} {ms[name]:7.3f} ms for {n / 1e6:.2f}M rays "
              f"(x6 depths = {DEPTHS * ms[name]:.2f} ms/sample)")
    floor = min(ms["diffuse"], ms["reflect"])
    figures = dict(
        n_rays=n, reps=reps,
        device=torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu",
        ms=ms, ms_per_sample={k: DEPTHS * v for k, v in ms.items()},
        headroom_ms_per_sample=DEPTHS * (ms["all_lobes"] - floor))
    print(json.dumps(figures), flush=True)
    return figures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_rays", nargs="?", type=int, default=2 * 512 * 512)
    p.add_argument("reps", nargs="?", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    return run(args.n_rays, args.reps, args.device)


if __name__ == "__main__":
    main()
