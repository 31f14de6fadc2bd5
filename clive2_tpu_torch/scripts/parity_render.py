"""The parity artifact of the reference's default still workload (the
port's counterpart of the JAX package's scripts/parity_render.py).

The reference's default still render (teapots, 1280x720, 15 samples, seed
0) under one estimator per process, as the JAX script renders it:

    python -m clive2_tpu_torch.scripts.parity_render            # production
    CLIVE2_REFERENCE_MIS=1 python -m clive2_tpu_torch.scripts.parity_render
    python -m clive2_tpu_torch.scripts.parity_render --report

A render runs on the card unless ``--device cpu``, writes
``parity_{production,refmis}_raw.npy`` and ``.png`` under output/parity/
(never docs/images/, which holds the JAX package's TPU renders of the same
workload), prints the JAX script's JSON record and fails on a non-finite
or black image.  ``--report`` prints the JAX script's record for the
port's two images (tone-mapped RMSE and MAE between the estimators, per
channel too, and their raw means' relative difference), then, per
estimator, the port's image against the committed TPU image of the same
estimator: per-channel raw means (BGR), their ratio and the tone-mapped
RMSE.  That comparison is a report, not a gate: the two estimators of the
TPU already differ by more than the two devices are expected to, and the
port pairs light subpaths otherwise under its Morton order.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "output", "parity")
TPU_IMAGES = os.path.join(ROOT, "docs", "images")
W, H, SPP = 1280, 720, 15
ESTIMATORS = ("production", "refmis")


def _write_png(raw, path):
    """``tone_map`` returns uint8 BGR: written flipped to RGB."""
    from PIL import Image

    from ..camera import tone_map

    Image.fromarray(np.asarray(tone_map(raw))[..., ::-1]).save(path)


def render(device="cuda"):
    import torch

    import clive2_tpu_torch as ct
    from .. import constants

    tag = "refmis" if constants.REFERENCE_MIS else "production"
    scene = ct.create_scene_from_preset("teapots", pixel_width=W,
                                        pixel_height=H, device=device)
    r = ct.Renderer(scene, seed=0)
    t0 = time.perf_counter()
    for _ in range(SPP):
        r.run_sample()
    r.block()
    dt = time.perf_counter() - t0
    raw = r.raw_image
    if not (np.isfinite(raw).all() and raw.mean() > 0):
        raise RuntimeError(f"parity_{tag}: the image is not finite or is "
                           "black")
    os.makedirs(OUT, exist_ok=True)
    np.save(os.path.join(OUT, f"parity_{tag}_raw.npy"), raw)
    _write_png(raw, os.path.join(OUT, f"parity_{tag}.png"))
    dev = torch.device(device)
    print(json.dumps({
        "row": f"parity_{tag}", "w": W, "h": H, "spp": SPP,
        "seconds": round(dt, 1),
        "raw_mean": float(raw.mean()), "raw_max": float(raw.max()),
        "nan": int(np.isnan(raw).sum()),
        "raw_mean_bgr": [float(x) for x in raw.mean(axis=(0, 1))],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu"}), flush=True)
    return raw


def _tm(x):
    """Float gamma map in [0, 1] (sqrt: the reference's 0.5 gamma), free of
    the uint8 tone map's quantisation and of 0/0 at black."""
    return np.sqrt(np.clip(x, 0.0, 1.0))


def report(out=OUT, tpu=TPU_IMAGES):
    """The JAX script's record for the images in ``out``, then each against
    the TPU's image of its estimator in ``tpu``; returns both records."""
    a, b = (np.load(os.path.join(out, f"parity_{t}_raw.npy"))
            for t in ESTIMATORS)
    ta, tb = _tm(a), _tm(b)
    rec = {"row": "parity_report", "spp": SPP,
           "rmse_tonemapped": float(np.sqrt(np.mean((ta - tb) ** 2))),
           "mae_tonemapped": float(np.abs(ta - tb).mean())}
    for ch, name in enumerate("bgr"):
        rec[f"rmse_{name}"] = float(np.sqrt(np.mean(
            (ta[..., ch] - tb[..., ch]) ** 2)))
    rec["raw_rel_mean_diff"] = float(
        abs(a.mean() - b.mean()) / max(a.mean(), 1e-12))
    print(json.dumps(rec, indent=1))

    vs = {"row": "parity_vs_tpu", "spp": SPP}
    for tag, port in zip(ESTIMATORS, (a, b)):
        ref = np.load(os.path.join(tpu, f"parity_{tag}_raw.npy"))
        pm, rm = port.mean(axis=(0, 1)), ref.mean(axis=(0, 1))
        vs[tag] = dict(
            port_mean_bgr=[float(x) for x in pm],
            tpu_mean_bgr=[float(x) for x in rm],
            mean_ratio_bgr=[float(x) for x in pm / np.maximum(rm, 1e-12)],
            rmse_tonemapped=float(np.sqrt(np.mean(
                (_tm(port) - _tm(ref)) ** 2))))
    print(json.dumps(vs, indent=1))
    return rec, vs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--report", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.report:
        report()
    else:
        render(args.device)


if __name__ == "__main__":
    main()
