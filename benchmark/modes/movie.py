"""The turntable movie: upstream ``movie.py``'s loop, driven through the
program's own ``clive2_tpu_torch.apps.movie.Movie``.  Frame f of the
orbit (``reference/orbit.py``) renders ``samples_per_frame`` samples on a
fresh renderer seeded ``seed + f``, then the frame boundary reads the
image back, tone-maps it, writes its PNG and moves the camera
(``Scene.with_camera``) for the next frame.  The window continues the
movie where set-up left it and wraps after the last frame.

Traffic parameters (``traffic/<name>.json``): ``width``, ``height``,
``frames``, ``samples_per_frame``, ``warmup_samples`` (frame 0's first
samples, run in set-up), ``trace_samples`` (the samples the ``--trace 1``
run profiles; as many as a frame has, so that the stretch holds one
frame boundary).

The unit of work is a sample.  The checked sample is chosen as in
``progressive.py``: the first to start after a share of the window's
first 45% drawn from the seed.  It is sample i of frame f by the
session's own count; after the window the reference renders it from
``fold_in(key(seed + f), i)`` on the configuration's scene seen from
frame f's orbit camera.  ``count_gap`` is taken on frame f's renderer,
whose final count is read when the frame ends (or the window does).
``frames_unwritten`` counts the frames the run finished whose PNG is
missing or does not decode to height x width x 3.  The frames go to
``_work/movie/``, emptied as the session starts and removed by the check.
"""

from __future__ import annotations

import gc
import os
import random
import shutil

import torch

UNIT = "sample"


def frames_dir():
    from .. import run

    return os.path.join(run.WORK, "movie")


def frame_path(out_dir, f: int) -> str:
    return os.path.join(out_dir, f"frame_{f:04d}.png")


class Session:
    """The program under test, set up for one run of a cell."""

    def __init__(self, config, traffic, seed: int, device):
        from clive2_tpu_torch.apps.movie import Movie

        self.config = config
        self.traffic = traffic
        self.width = int(traffic["width"])
        self.height = int(traffic["height"])
        self.frames = int(traffic["frames"])
        self.per_frame = int(traffic["samples_per_frame"])
        # frame f's key is seed + f, a 32-bit seed for every frame
        self.seed = int(seed) % (2 ** 32 - self.frames)
        self.device = device
        self.out_dir = frames_dir()
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.movie = Movie(config["preset"], self.width, self.height,
                           self.frames, self.per_frame, seed=self.seed,
                           out_dir=self.out_dir, device=device)
        scene = self.movie.base_scene
        self.scene_build_s = float(scene.build_seconds)
        self.n_triangles = int(scene.n_triangles)
        self.k = 0                      # samples asked for, warm-ups included
        self.finished = []              # frames ended, in order
        self.before = self.after = None
        self.checked_frame = self.checked_index = None
        self.final = None               # the checked frame's final count
        self.asked = 0                  # samples asked of the checked frame
        self.warmups = int(traffic["warmup_samples"])
        for _ in range(self.warmups):
            self._sample()
        self.movie.renderer.block()
        self.check_at = 0.45 * random.Random(self.seed).random()

    @property
    def checked(self) -> bool:
        return self.after is not None

    def _frame_of(self, k: int) -> int:
        return (k // self.per_frame) % self.frames

    def _sample(self, take=False):
        """Sample ``k`` of the movie; with ``take``, keep the renderer's
        state before and after it."""
        m = self.movie
        crossing = self.k > 0 and self.k % self.per_frame == 0
        if crossing:
            ended = self._frame_of(self.k - 1)
            self.finished.append(ended)
            if self.checked_frame == ended and self.final is None:
                self.final = int(m.renderer.samples)
        if take:
            r = m.ready()
            self.before = r.state
            self.checked_frame = self._frame_of(self.k)
            self.checked_index = self.k % self.per_frame
            self.asked = self.checked_index
        m.step()
        if take:
            self.after = m.renderer.state
        if self.final is None and self.checked_frame is not None:
            self.asked += 1
        self.k += 1

    def step(self, share_elapsed: float):
        """One sample; ``share_elapsed`` is the share of the window gone
        when it starts (the host's clock)."""
        self._sample(take=self.before is None
                     and share_elapsed >= self.check_at)

    def release(self):
        """Free the program's movie, keeping the checked states; returns
        the checked frame's final sample count."""
        if self.final is None:
            self.final = int(self.movie.renderer.samples)
        del self.movie
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return self.final


def frames_unwritten(out_dir, frames, height, width) -> int:
    """The frames among ``frames`` whose PNG is missing or is not an
    RGB image of ``height`` x ``width``."""
    import numpy as np
    from PIL import Image

    bad = 0
    for f in sorted(set(frames)):
        try:
            with Image.open(frame_path(out_dir, f)) as im:
                shape = np.asarray(im).shape
        except (OSError, ValueError):
            shape = None
        bad += shape != (height, width, 3)
    return bad


def reference_sample(config, traffic, seed: int, frame: int, index: int,
                     resource_dir, device):
    """The reference's sample ``index`` of frame ``frame``: the renderer
    seeded ``seed + frame`` on the configuration's scene seen from that
    frame's orbit camera."""
    from ..reference import rng
    from ..reference.integrator.render import render_sample
    from ..reference.orbit import orbit_scene
    from ..reference.scene import build_scene

    w, h = int(traffic["width"]), int(traffic["height"])
    desc = orbit_scene(config["scene"], frame, int(traffic["frames"]))
    scene = build_scene(desc, w, h, resource_dir, device)
    key = rng.fold_in(rng.key(int(seed) + frame, device=device), index)
    return render_sample(key, scene, w, h)


def check(session: Session, resource_dir):
    """The compared numbers of the session's checked sample (None when
    the window never reached it), with ``frames_unwritten``."""
    from .. import compare

    s = session
    unwritten = frames_unwritten(s.out_dir, s.finished, s.height, s.width)
    shutil.rmtree(s.out_dir, ignore_errors=True)
    if s.after is None:
        return None
    final = s.release()
    with torch.no_grad():
        sample = reference_sample(s.config, s.traffic, s.seed,
                                  s.checked_frame, s.checked_index,
                                  resource_dir, s.device)
        values = compare.numbers(s.before, s.after, sample, final, s.asked)
    return dict(values, frames_unwritten=unwritten)
