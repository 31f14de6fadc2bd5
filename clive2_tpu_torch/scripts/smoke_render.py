"""End-to-end smoke render through the public API: Cornell box -> PNG (the
port's counterpart of the JAX package's scripts/smoke_render.py, with the
same flags, prints and files).

    python -m clive2_tpu_torch.scripts.smoke_render --size=128 --spp=4
    python -m clive2_tpu_torch.scripts.smoke_render --cpu --size=96 --spp=8

Renders the ``empty`` preset at ``--size`` x ``--size`` for ``--spp``
samples, seed 7, on the card unless ``--cpu`` (without a card the default
raises), prints the scene, the first sample's time, the steady state's
s/sample and the raw and unidirectional images' statistics, and writes
output/smoke_bdpt.png and output/smoke_uni.png under the working
directory.
"""

from __future__ import annotations

import argparse
import os
import time

from PIL import Image


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the card)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--spp", type=int, default=2)
    args = p.parse_args(argv)

    import clive2_tpu_torch as ct

    t0 = time.time()
    scene = ct.create_scene_from_preset(
        "empty", pixel_width=args.size, pixel_height=args.size,
        device="cpu" if args.cpu else "cuda")
    print(f"scene: {scene.n_triangles} tris, {scene.n_nodes} nodes, "
          f"built in {scene.build_seconds:.2f}s")

    r = ct.Renderer(scene, seed=7)
    t1 = time.time()
    r.run_sample()
    r.block()
    print(f"first sample (incl. compile): {time.time() - t1:.1f}s")
    t2 = time.time()
    for _ in range(args.spp - 1):
        r.run_sample()
    r.block()
    if args.spp > 1:
        print(f"steady-state: {(time.time() - t2) / (args.spp - 1):.2f}"
              "s/sample")

    raw = r.raw_image
    print("raw image stats: min %.4f mean %.4f max %.4f, nonzero %.1f%%" % (
        raw.min(), raw.mean(), raw.max(), 100 * (raw.sum(axis=2) > 0).mean()))
    uni = r.raw_unidirectional
    print("unidirectional:  min %.4f mean %.4f max %.4f, nonzero %.1f%%" % (
        uni.min(), uni.mean(), uni.max(), 100 * (uni.sum(axis=2) > 0).mean()))

    os.makedirs("output", exist_ok=True)
    Image.fromarray(r.image[:, :, ::-1]).save("output/smoke_bdpt.png")
    Image.fromarray(r.unidirectional_image[:, :, ::-1]).save(
        "output/smoke_uni.png")
    print("wrote output/smoke_bdpt.png, output/smoke_uni.png")
    print(f"total {time.time() - t0:.1f}s")
    return r


if __name__ == "__main__":
    main()
