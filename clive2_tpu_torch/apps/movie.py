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

The frame loop is ``Movie``, which the CLI drives one sample at a time,
as any other caller can.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

from ..utils.profiling import span
from .render import add_device_flags, make_display, save_png


class Movie:
    """The turntable movie of preset ``scene``, one sample a ``step()``.

    Frames are ``range(start_frame + frame_offset, frames, frame_stride)``
    of an orbit of ``frames`` frames at ``width`` x ``height``; the range
    starts again after its last frame.  The scene and its BVH are built
    for the range's first frame (the base scene); any other frame is the
    base scene ``with_camera`` its ``orbit_camera``.  Frame f renders
    ``samples`` samples with a fresh ``Renderer`` seeded ``seed + f`` and
    is written to ``<out_dir>/frame_ffff.png``.

    ``step()`` runs one sample of the current frame.  When the current
    frame has all its samples, or was ended, it first crosses the frame
    boundary (``ready``), inside one ``clive2.frame`` span: it ends the
    frame (``end_frame``) unless that was done, and begins the next
    (``begin_frame``).  The CLI ends each frame itself, so that the frame's
    printed time holds its PNG; there the span holds ``frame.camera``
    alone.  ``frame`` and ``renderer`` are the current frame's index and
    renderer (``renderer`` is None between a frame's end and the next
    one's beginning); ``frames_written`` lists the frames' PNG paths in
    the order written.  The old frame's renderer is dropped before the
    next is built, so that two frames' accumulators are never held at
    once.
    """

    def __init__(self, scene: str, width: int = 1280, height: int = 720,
                 frames: int = 120, samples: int = 15, seed: int = 0,
                 out_dir: str = "output/test-movie", device="cuda",
                 start_frame: int = 0, frame_stride: int = 1,
                 frame_offset: int = 0, show=None):
        from ..scene import create_scene_from_preset_with_params

        self.width, self.height = width, height
        self.total_frames = frames
        self.samples = samples
        self.seed = seed
        self.out_dir = out_dir
        self.show = show
        self.frames = range(start_frame + frame_offset, frames,
                            frame_stride)
        if not self.frames:
            raise ValueError(f"no frame in {self.frames}")
        if samples < 1:
            raise ValueError(f"a frame needs a sample, not {samples}")
        self.frames_written = []
        self._next = 0                       # position in ``frames``
        self.base_frame = self.frames[0]
        self.base_scene = create_scene_from_preset_with_params(
            scene, pixel_width=width, pixel_height=height,
            frame_idx=self.base_frame, total_frames=frames, device=device)
        self.frame = self.renderer = None
        self.begin_frame()

    def begin_frame(self):
        """Begin the next frame of the range: its camera and scene and a
        fresh renderer."""
        from ..renderer import Renderer
        from ..scene import orbit_camera

        f = self.frames[self._next]
        self._next = (self._next + 1) % len(self.frames)
        with span("frame.camera"):
            scene = self.base_scene if f == self.base_frame else \
                self.base_scene.with_camera(orbit_camera(
                    f, self.total_frames, self.width, self.height))
            self.frame = f
            self.renderer = Renderer(scene, seed=self.seed + f)

    def end_frame(self) -> str:
        """Finish the current frame: wait for its samples, tone-map its
        image, show it and write its PNG; then drop its renderer.  Returns
        the PNG's path."""
        with span("frame.image"):
            self.renderer.block()
            image = self.renderer.image
        if self.show is not None:
            self.show(image)
        path = os.path.join(self.out_dir, f"frame_{self.frame:04d}.png")
        with span("frame.save"):
            save_png(path, image)
        self.frames_written.append(path)
        self.renderer = None
        return path

    def ready(self):
        """The renderer of the frame that the next sample belongs to: the
        current one, or, when it is complete (or ended), the next frame's,
        after the frame boundary."""
        if self.renderer is None or self.renderer.samples >= self.samples:
            with span("frame"):
                if self.renderer is not None:
                    self.end_frame()
                self.begin_frame()
        return self.renderer

    def step(self):
        """One sample, of the frame ``ready()`` gives."""
        self.ready().run_sample()


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

    if args.start_frame == 0 and args.frame_offset == 0 and \
            args.frame_stride == 1:
        empty_movie_dir(args)
    os.makedirs(movie_dir(args), exist_ok=True)

    if args.start_frame + args.frame_offset >= args.movie_frames:
        return
    show = make_display(args.display)
    frame_start = time.time()
    movie = Movie(args.scene, args.width, args.height, args.movie_frames,
                  args.samples, args.seed, movie_dir(args), args.device,
                  start_frame=args.start_frame,
                  frame_stride=args.frame_stride,
                  frame_offset=args.frame_offset, show=show)
    for n, f in enumerate(movie.frames):
        if n:
            frame_start = time.time()
        for i in range(args.samples):
            t0 = time.time()
            movie.step()
            print(f"Sample {i} time: {time.time() - t0:.3f}")
        movie.end_frame()
        print(f"Frame {f} time: {time.time() - frame_start:.2f}")


if __name__ == "__main__":
    main()
