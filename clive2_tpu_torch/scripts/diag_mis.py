"""Per-class, per-strategy MIS diagnostic (the port's counterpart of the
JAX package's scripts/diag_mis.py, with the same arguments and prints).

For each transport class k (the number of path vertices t + s), every BDPT
strategy with t + s = k is an unbiased estimator of the same class-k
transport integral.  This renders, at many samples on a small Cornell:

  * uni_k     the unidirectional (BSDF-sampled) class-k image, from every
              light hit of the camera path at vertex index k-1;
  * unw(t,s)  each strategy's unweighted estimate (w := 1);
  * w(t,s)    each strategy's weighted estimate and its weight image.

and prints per class:
  1. unbiasedness: mean(unw(t,s)) against mean(uni_k) for each strategy (a
     deviation is an estimator fault in that strategy, not of MIS);
  2. partition: the sum over the class of mean(w(t,s)) against
     mean(uni_k) (a deviation with every strategy unbiased is a fault of
     the weights' partition of unity).

On a healthy estimator each (t, 0) strategy's unweighted mean equals uni's
(they are the same estimate), and classes 2-6 agree with uni to about 1.5%
per strategy and 1% for the weighted sum at a few hundred samples; classes
7-12 have no unidirectional image (uni mean 0).  Sample i takes
``rng.fold_in(key(7), i)``, the keys of the JAX script.  The images sum on
the device and reach the host once, at the end.

    python -m clive2_tpu_torch.scripts.diag_mis [spp] [size] [classes...]
        [--device cuda|cpu]

``classes`` are taken and ignored, as the JAX script, whose usage names
them, ignores them: every class is reported.  Prints the JAX script's
lines, then one JSON line of the same figures.  Runs on the card unless ``--device cpu`` (without a card the
default raises).  ``CLIVE2_REFERENCE_MIS=1`` diagnoses the reference's
estimator.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from .. import constants, rng
from ..constants import MAX_BOUNCES
from ..integrator.connect import connect_paths
from ..integrator.trace import (generate_camera_rays, generate_light_rays,
                                trace_subpaths)
from .kernel_stats import resolve_device

SEED = 7


def per_class_uni(path, k, height, width):
    """Class-k unidirectional image: any light hit at vertex index k-1 (not
    only the first: BDPT covers paths whose inner vertices also lie on the
    emitter), the vertex's prior color over its total importance."""
    d = k - 1
    V = path["vertices"]
    sel = path["valid"][d] & (V["hit_light"][d] >= 0)
    prior = V["color"][d - 1] if d >= 1 else torch.ones_like(V["color"][0])
    out = prior / torch.clamp(V["tot_importance"][d], min=1e-30)[:, None]
    return torch.where(sel[:, None], out, 0.0).reshape(height, width, 3)


def merged_paths(key, data, width, height):
    """Camera and light rays of every pixel in raster order, traced as one
    merged wavefront: (cam_path, light_path), lane i of each pixel i."""
    k_cam, k_light, k_trace = rng.split(key, 3)
    n = width * height
    cam_rays, _ = generate_camera_rays(k_cam, data["camera"], width, height)
    light_rays = generate_light_rays(k_light, data["lights"], data["mat"], n)
    merged = {k: torch.cat([cam_rays[k], light_rays[k]]) for k in cam_rays}
    fc = torch.cat([torch.ones(n, dtype=torch.bool, device=key.device),
                    torch.zeros(n, dtype=torch.bool, device=key.device)])
    path = trace_subpaths(k_trace, merged, data, from_camera=fc)

    def half(sl):
        return dict(vertices={k: v[:, sl] for k, v in
                              path["vertices"].items()},
                    valid=path["valid"][:, sl], length=path["length"][sl])

    return half(slice(0, n)), half(slice(n, 2 * n))


def one_sample(key, data, width, height):
    """One sample's per-strategy images ((t, s) -> dict(weighted,
    unweighted, weight)) and its class-k unidirectional images, k = 2 ..
    MAX_BOUNCES (class k needs vertex k-1)."""
    cam_path, light_path = merged_paths(key, data, width, height)
    conn = connect_paths(cam_path, light_path, data, width, height,
                         debug_per_strategy=True)
    unis = {k: per_class_uni(cam_path, k, height, width)
            for k in range(2, MAX_BOUNCES + 1)}
    return conn["per_strategy"], unis


def accumulate(data, width, height, spp, key):
    """Per-strategy and per-class images averaged over ``spp`` samples, on
    the host: (strategies, unis) of numpy arrays."""
    acc_ps = acc_uni = None
    for i in range(spp):
        ps, unis = one_sample(rng.fold_in(key, i), data, width, height)
        if acc_ps is None:
            acc_ps, acc_uni = ps, unis
        else:
            for ts, images in ps.items():
                for kind, img in images.items():
                    acc_ps[ts][kind] += img
            for k, img in unis.items():
                acc_uni[k] += img
    acc_ps = {ts: {kind: (img / spp).cpu().numpy() for kind, img in
                   images.items()} for ts, images in acc_ps.items()}
    acc_uni = {k: (img / spp).cpu().numpy() for k, img in acc_uni.items()}
    return acc_ps, acc_uni


def report(acc_ps, acc_uni, out=print):
    """Print the JAX script's per-class report; returns its figures:
    class -> dict(uni, strategies: "t,s" -> dict(unweighted, weighted,
    wmean, ratio), sum_weighted, sum_ratio); a ratio is None where the
    class has no unidirectional image."""
    figures = {}
    for k in sorted({t + s for (t, s) in acc_ps}):
        uni_mean = float(acc_uni[k].mean()) if k in acc_uni else 0.0
        out(f"\n== class k={k} (uni mean {uni_mean:.6g}) ==")
        strategies, tot_weighted = {}, 0.0
        for (t, s) in sorted(ts for ts in acc_ps if sum(ts) == k):
            d = acc_ps[(t, s)]
            mu = float(d["unweighted"].mean())
            mw = float(d["weighted"].mean())
            wmean = float(d["weight"].mean())
            tot_weighted += mw
            ratio = mu / uni_mean if uni_mean > 0 else None
            out(f"  (t={t},s={s}): unweighted {mu:.6g} "
                f"({math.nan if ratio is None else ratio:6.3f}x uni)"
                f"  weighted {mw:.6g}  wmean {wmean:.4f}")
            strategies[f"{t},{s}"] = dict(unweighted=mu, weighted=mw,
                                          wmean=wmean, ratio=ratio)
        sum_ratio = None
        if uni_mean > 0:
            sum_ratio = tot_weighted / uni_mean
            out(f"  SUM weighted {tot_weighted:.6g} ({sum_ratio:6.3f}x uni)")
        figures[k] = dict(uni=uni_mean, strategies=strategies,
                          sum_weighted=tot_weighted, sum_ratio=sum_ratio)
    return figures


def run(spp=64, size=32, device="cuda"):
    """The diagnostic on Cornell ``empty`` at ``size`` x ``size`` and
    ``spp`` samples on ``device``; prints the report and its JSON line and
    returns the figures."""
    import clive2_tpu_torch as ct

    device = resolve_device(device)
    scene = ct.create_scene_from_preset("empty", pixel_width=size,
                                        pixel_height=size, device=device)
    acc_ps, acc_uni = accumulate(scene.data, size, size, spp,
                                 rng.key(SEED, device))
    print(f"spp={spp} size={size}x{size}")
    figures = dict(
        spp=spp, size=size, reference_mis=constants.REFERENCE_MIS,
        device=torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu",
        n_strategies=len(acc_ps),
        classes=report(acc_ps, acc_uni))
    print(json.dumps(figures), flush=True)
    return figures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("spp", nargs="?", type=int, default=64)
    p.add_argument("size", nargs="?", type=int, default=32)
    p.add_argument("classes", nargs="*", type=int,
                   help="taken and ignored, as by the JAX script")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    return run(args.spp, args.size, args.device)


if __name__ == "__main__":
    main()
