"""Progressive full frames: the render CLI's loop, ``Renderer.run_sample()``
back to back on one scene, each call one BDPT sample of every pixel,
accumulated into the renderer's state.

Traffic parameters (``traffic/<name>.json``): ``width``, ``height``,
``warmup_samples`` (run in set-up), ``trace_samples`` (the samples the
``--trace 1`` run profiles, from the middle of the window).

The unit of work is a sample.  One sample of the window, the first to
start after a share of its first 45% drawn from the seed (ahead of the
traced stretch), is checked: the
renderer's state before and after it is kept, and after the window the
reference renders that sample (``check``).
"""

from __future__ import annotations

import gc
import random

import torch

UNIT = "sample"


class Session:
    """The program under test, set up for one run of a cell."""

    def __init__(self, config, traffic, seed: int, device):
        import clive2_tpu_torch as ct

        self.config = config
        self.traffic = traffic
        self.width = int(traffic["width"])
        self.height = int(traffic["height"])
        self.seed = int(seed) % 2 ** 32       # the renderer's key is 32 bits
        self.device = device
        self.scene = ct.create_scene_from_preset(
            config["preset"], self.width, self.height, device=device)
        self.scene_build_s = float(self.scene.build_seconds)
        self.n_triangles = int(self.scene.n_triangles)
        self.renderer = ct.Renderer(self.scene, seed=self.seed,
                                    device=device)
        self.warmups = int(traffic["warmup_samples"])
        for _ in range(self.warmups):
            self.renderer.run_sample()
        self.renderer.block()
        # the checked sample: the first to start after this share of the
        # window
        self.check_at = 0.45 * random.Random(self.seed).random()
        self.before = self.after = None
        self.checked_index = None
        self.steps = 0

    @property
    def checked(self) -> bool:
        return self.after is not None

    def step(self, share_elapsed: float):
        """One sample; ``share_elapsed`` is the share of the window gone
        when it starts (the host's clock)."""
        r = self.renderer
        take = self.before is None and share_elapsed >= self.check_at
        if take:
            self.before = r.state
            self.checked_index = r.samples
        r.run_sample()
        if take:
            self.after = r.state
        self.steps += 1

    def release(self):
        """Free the program's scene and renderer, keeping the checked
        states; returns the renderer's final sample count."""
        final = int(self.renderer.samples)
        del self.renderer, self.scene
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return final


def reference_sample(config, traffic, seed: int, index: int, resource_dir,
                     device, scene=None):
    """The reference's sample ``index`` of the renderer seeded ``seed``
    (and the reference scene it built, to be passed back for another)."""
    from ..reference import rng
    from ..reference.integrator.render import render_sample
    from ..reference.scene import build_scene

    w, h = int(traffic["width"]), int(traffic["height"])
    if scene is None:
        scene = build_scene(config["scene"], w, h, resource_dir, device)
    key = rng.fold_in(rng.key(int(seed) % 2 ** 32, device=device), index)
    return render_sample(key, scene, w, h), scene


def check(session: Session, resource_dir):
    """The compared numbers of the session's checked sample (None when
    the window never reached it)."""
    from .. import compare

    if session.after is None:
        return None
    final = session.release()
    with torch.no_grad():
        sample, _ = reference_sample(session.config, session.traffic,
                                     session.seed, session.checked_index,
                                     resource_dir, session.device)
        return compare.numbers(session.before, session.after, sample, final,
                               session.warmups + session.steps)
