"""Render orchestrator: progressive accumulation, images, checkpoints (port
of clive2_tpu/renderer.py, full-frame samples only).

Accumulators live on the renderer's device and are copied to the host only
for display or saving.  Checkpoints use the JAX package's file format, RNG
key words included, so a JAX checkpoint resumes here and continues the same
random stream.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import rng
from .camera import tone_map
from .constants import MAX_BOUNCES, timed
from .integrator.render import accumulate, init_accumulators, render_sample
from .scene import Scene


class Renderer:
    def __init__(self, scene: Scene, seed: int = 0,
                 max_bounces: int = MAX_BOUNCES, device=None):
        """``device`` defaults to the scene's device and must match it."""
        device = torch.device(scene.device if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is "
                               "not available")
        if device.type != scene.device.type:
            raise ValueError(f"scene is on {scene.device}, renderer asked "
                             f"for {device}")
        self.scene = scene
        self.device = device
        self.width = scene.pixel_width
        self.height = scene.pixel_height
        self.max_bounces = max_bounces
        self.key = rng.key(seed, device=scene.device)
        self.samples = 0
        self.state = init_accumulators(self.width, self.height,
                                       device=scene.device)

    @timed
    def run_sample(self):
        """One progressive BDPT sample over every pixel.  The sample key
        folds the sample index into the seed key, as the JAX package does."""
        sample = render_sample(
            rng.fold_in(self.key, self.samples), self.scene.data,
            self.width, self.height, self.max_bounces)
        self.last_n_rays = sample["n_rays"]
        self.state = accumulate(self.state, sample)
        self.samples += 1

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- images -----------------------------------------------------------

    def _host(self, name) -> np.ndarray:
        return self.state[name].cpu().numpy()

    @property
    def raw_image(self) -> np.ndarray:
        img = self._host("summed_image")
        w = self._host("summed_weight")[..., None]
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.nan_to_num(img / w, posinf=0, neginf=0)

    @property
    def image(self) -> np.ndarray:
        return tone_map(self.raw_image, exposure=4.0)

    @property
    def raw_unidirectional(self) -> np.ndarray:
        img = self._host("summed_unidirectional")
        n = np.maximum(self._host("pixel_count"), 1.0)[..., None]
        return np.nan_to_num(img / n, posinf=0, neginf=0)

    @property
    def unidirectional_image(self) -> np.ndarray:
        return tone_map(self.raw_unidirectional, exposure=4.0)

    # ---- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        """Accumulators, sample counter and key words (the JAX format)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(
            path,
            **{k: self._host(k) for k in (
                "summed_image", "summed_weight", "summed_unidirectional",
                "n_samples", "summed_sq", "pixel_count")},
            samples=self.samples,
            key_data=np.asarray(rng.key_data(self.key), dtype=np.uint32),
        )

    def load_checkpoint(self, path: str):
        dev = self.scene.device
        hw = (self.height, self.width)
        with np.load(path) as ckpt:
            get = lambda k: torch.as_tensor(ckpt[k]).to(dev)
            self.state = dict(
                summed_image=get("summed_image"),
                summed_weight=get("summed_weight"),
                summed_unidirectional=get("summed_unidirectional"),
                n_samples=get("n_samples").to(torch.int32),
                summed_sq=(get("summed_sq") if "summed_sq" in ckpt
                           else torch.zeros(hw, device=dev)),
                # checkpoints from before adaptive sampling: every pixel
                # had `samples` samples
                pixel_count=(get("pixel_count") if "pixel_count" in ckpt
                             else torch.full(hw, float(ckpt["samples"]),
                                             device=dev)),
            )
            self.samples = int(ckpt["samples"])
            self.key = rng.wrap_key_data(ckpt["key_data"], device=dev)
