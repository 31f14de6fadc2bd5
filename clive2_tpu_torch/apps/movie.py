"""Turntable-animation CLI: an orbiting camera, one PNG per frame (port of
clive2_tpu/apps/movie.py, with the same flags and outputs).

    python -m clive2_tpu_torch.apps.movie --scene teapots --movie-frames 120

The scene and its BVH are built once, for the first frame this process
renders; later frames only move the camera (``Scene.with_camera`` with
``orbit_camera``).  Frame f renders with seed ``--seed + f`` into
``<output-dir>/<movie-name>/frame_ffff.png``.  Frames split across
processes with ``--frame-stride``/``--frame-offset`` (process k of n:
``--frame-stride n --frame-offset k``; ``scripts/movie_launcher.py``
starts them).  The movie's folder is emptied only by an unsharded run
(stride 1) that starts at frame 0; a sharded run leaves that to its
launcher, which empties it before any of its processes starts, so that no
process deletes the frames another has written.  Renders on the card
unless ``--device cpu``; ``--aot-cache`` is accepted and has no effect.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

from .render import add_device_flags, make_display, save_png


def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samples", type=int, default=15)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--scene", type=str, default="teapots")
    parser.add_argument("--movie-name", type=str, default="test-movie")
    parser.add_argument("--movie-frames", type=int, default=120)
    parser.add_argument("--start-frame", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default="output")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frame-stride", type=int, default=1,
                        help="render every k-th frame (multi-process "
                        "sharding)")
    parser.add_argument("--frame-offset", type=int, default=0)
    parser.add_argument("--display", choices=("auto", "on", "off"),
                        default="auto",
                        help="cv2 live window per frame; auto = on when cv2 "
                        "+ a display exist")
    add_device_flags(parser)
    return parser


def movie_dir(args) -> str:
    return os.path.join(args.output_dir, args.movie_name)


def empty_movie_dir(args):
    """Remove the movie's folder, frames of earlier runs included."""
    if os.path.exists(movie_dir(args)):
        shutil.rmtree(movie_dir(args))


def main(argv=None):
    args = make_parser().parse_args(argv)

    from ..renderer import Renderer
    from ..scene import create_scene_from_preset_with_params, orbit_camera

    if args.start_frame == 0 and args.frame_offset == 0 and \
            args.frame_stride == 1:
        empty_movie_dir(args)
    os.makedirs(movie_dir(args), exist_ok=True)

    frames = range(args.start_frame + args.frame_offset, args.movie_frames,
                   args.frame_stride)
    base_scene = None
    show = make_display(args.display)
    for f in frames:
        frame_start = time.time()
        if base_scene is None:
            base_scene = create_scene_from_preset_with_params(
                args.scene, pixel_width=args.width,
                pixel_height=args.height, frame_idx=f,
                total_frames=args.movie_frames, device=args.device)
            scene = base_scene
        else:
            scene = base_scene.with_camera(
                orbit_camera(f, args.movie_frames, args.width, args.height))
        renderer = Renderer(scene, seed=args.seed + f)
        for i in range(args.samples):
            t0 = time.time()
            renderer.run_sample()
            print(f"Sample {i} time: {time.time() - t0:.3f}")
        renderer.block()
        if show is not None:
            show(renderer.image)
        save_png(os.path.join(movie_dir(args), f"frame_{f:04d}.png"),
                 renderer.image)
        print(f"Frame {f} time: {time.time() - frame_start:.2f}")


if __name__ == "__main__":
    main()
