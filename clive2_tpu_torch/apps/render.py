"""Still-render CLI: progressive BDPT render of a preset scene (port of
clive2_tpu/apps/render.py, with the same flags and outputs).

    python -m clive2_tpu_torch.apps.render --scene empty --samples 16

Renders on the card unless ``--device cpu`` asks for the CPU (there is no
fallback: without a card ``--device cuda`` raises).  Writes a timestamped
PNG into ``--output-dir`` (and its unidirectional twin with
``--unidirectional``), resumes from ``--checkpoint`` when the file exists,
and can show each sample in a cv2 window (``--display``, when cv2 imports
and a display exists) or write ``preview.png`` every few samples.
``--aot-cache`` is accepted for the JAX CLI's scripts and has no effect:
the kernels are built once per checkout and the rest needs no compile.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np


def save_png(path: str, bgr_u8: np.ndarray):
    """Write a BGR image as an RGB PNG at zlib's fastest level, the one
    upstream's ``cv2.imwrite`` writes at by default (Pillow's default,
    level 6, spends more than twice the time on a noisy frame to save a
    few percent of its bytes)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(bgr_u8[:, :, ::-1]).save(path, compress_level=1)


def make_display(mode: str):
    """A show(bgr_u8) callable, or None when display is off.  'auto'
    opens the window only when cv2 imports and a display exists; 'on'
    demands both (raises otherwise)."""
    if mode == "off":
        return None
    has_display = bool(os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY")
                       or os.name == "nt")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None or not has_display:
        if mode == "on":
            raise RuntimeError(
                "--display on requires cv2 and a display "
                f"(cv2={'yes' if cv2 else 'no'}, display="
                f"{'yes' if has_display else 'no'})")
        return None

    def show(bgr_u8):
        cv2.imshow("render", bgr_u8)
        cv2.waitKey(1)

    return show


def add_device_flags(parser):
    """The flags both CLIs add to the JAX CLIs': the device, and the
    accepted ``--aot-cache``."""
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="render on the card (default; raises without "
                        "one) or on the CPU")
    parser.add_argument("--aot-cache", type=str,
                        default=os.environ.get("CLIVE2_AOT_CACHE",
                                               "output/.aot-cache"),
                        help="accepted for the JAX CLI's scripts; no effect")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samples", type=int, default=15)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--save-on-quit", action="store_true")
    parser.add_argument("--scene", type=str, default="teapots")
    parser.add_argument("--output-dir", type=str, default="output/default")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--preview-every", type=int, default=0,
                        help="write a preview PNG every N samples (0 = off)")
    parser.add_argument("--display", choices=("auto", "on", "off"),
                        default="auto",
                        help="cv2 live preview window per sample; 'auto' = "
                        "on when cv2 + a display exist, silently off "
                        "otherwise")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint file; resumes if it exists")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    parser.add_argument("--unidirectional", action="store_true",
                        help="also save the plain path-traced image")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--chunk-rows", type=int, default=None,
                        help="render in row stripes of this height (bounds "
                        "the path arrays' memory for 4K-class frames)")
    parser.add_argument("--adaptive-after", type=int, default=0,
                        help="after N uniform warmup samples, sample only "
                        "the highest-variance pixels (0 = always uniform)")
    parser.add_argument("--adaptive-fraction", type=float, default=0.25,
                        help="fraction of pixels per adaptive sample")
    add_device_flags(parser)
    args = parser.parse_args(argv)

    from .. import constants
    constants.TIMED_ENABLED = args.timing

    from ..renderer import Renderer
    from ..scene import create_scene_from_preset

    scene = create_scene_from_preset(
        args.scene, pixel_width=args.width, pixel_height=args.height,
        device=args.device)
    print(f"scene '{args.scene}': {scene.n_triangles} triangles, "
          f"{scene.n_nodes} BVH nodes, built in {scene.build_seconds:.2f}s")

    renderer = Renderer(scene, seed=args.seed, chunk_rows=args.chunk_rows)
    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        print(f"resumed at sample {renderer.samples} from {args.checkpoint}")

    start = time.time()
    preview_path = os.path.join(args.output_dir, "preview.png")
    show = make_display(args.display)
    try:
        for i in range(renderer.samples, args.samples):
            if args.adaptive_after and i >= args.adaptive_after:
                renderer.run_adaptive_sample(args.adaptive_fraction)
            else:
                renderer.run_sample()
            print(f"Sample {i}/{args.samples} completed")
            if show is not None:
                show(renderer.image)
            if args.preview_every and (i + 1) % args.preview_every == 0:
                save_png(preview_path, renderer.image)
            if (
                args.checkpoint
                and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0
            ):
                renderer.save_checkpoint(args.checkpoint)
    except KeyboardInterrupt:
        if not args.save_on_quit:
            raise
        print("interrupted; saving current image")

    renderer.block()
    print(f"Rendering took {time.time() - start:.2f} seconds")

    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_path = os.path.join(args.output_dir, f"{stamp}.png")
    save_png(out_path, renderer.image)
    print(f"wrote {out_path}")
    if args.unidirectional:
        uni_path = os.path.join(args.output_dir, f"{stamp}_unidirectional.png")
        save_png(uni_path, renderer.unidirectional_image)
        print(f"wrote {uni_path}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
