"""Render orchestrator: progressive accumulation, images, checkpoints (port
of clive2_tpu/renderer.py).

A sample covers the whole frame, or the frame in row stripes
(``chunk_rows``) so that path arrays stay stripe-sized on the card, or
(``run_adaptive_sample``) only the pixels of highest variance.
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
from .integrator.render import (
    accumulate,
    init_accumulators,
    render_sample,
    render_sample_subset,
)
from .scene import Scene


def _adaptive_scores(state):
    """Per-pixel selection score from the accumulated statistics: the
    variance of the mean, relative to the squared display value (dark
    pixels matter less).  Flat [H*W]."""
    n = state["pixel_count"]
    # the display estimate is weight-normalised
    disp = state["summed_image"].mean(-1) / torch.clamp(
        state["summed_weight"], min=1e-6)
    ex2 = state["summed_sq"] / torch.clamp(n, min=1.0)
    var = torch.clamp(ex2 - disp * disp, min=0.0)
    return (var / torch.clamp(n, min=1.0) / (disp * disp + 1e-4)).reshape(-1)


def adaptive_select(state, n_select: int):
    """The ``n_select`` pixels of highest score, best first, ties to the
    lower pixel index: the order of the JAX package's ``lax.top_k``, which
    ``torch.topk`` does not promise (early variance maps hold many equal,
    e.g. zero, scores).  [n_select] i32 flat indices."""
    order = torch.sort(_adaptive_scores(state), descending=True, stable=True)
    return order.indices[:n_select].to(torch.int32)


class Renderer:
    def __init__(self, scene: Scene, seed: int = 0,
                 max_bounces: int = MAX_BOUNCES, device=None,
                 chunk_rows: int = None):
        """``device`` defaults to the scene's device and must match it.
        ``chunk_rows`` renders each sample in row stripes of that height,
        which must divide the image height (at or above it: full frames)."""
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
        if chunk_rows is not None and chunk_rows >= self.height:
            chunk_rows = None
        if chunk_rows is not None and self.height % chunk_rows:
            raise ValueError(f"chunk_rows ({chunk_rows}) must divide the "
                             f"image height ({self.height})")
        self.chunk_rows = chunk_rows

    @timed
    def run_sample(self):
        """One progressive BDPT sample over every pixel.  The sample key
        folds the sample index into the seed key, as the JAX package does;
        a striped renderer folds each stripe's first row into that, counts
        the sample at its last stripe and each pixel at its own stripe."""
        key = rng.fold_in(self.key, self.samples)
        if self.chunk_rows is None:
            sample = render_sample(key, self.scene.data, self.width,
                                   self.height, self.max_bounces)
            self.last_n_rays = sample["n_rays"]
            self.state = accumulate(self.state, sample)
        else:
            self.last_n_rays = 0
            rows = torch.arange(self.height, device=self.device)[:, None]
            for row0 in range(0, self.height, self.chunk_rows):
                sample = render_sample(
                    rng.fold_in(key, row0), self.scene.data, self.width,
                    self.height, self.max_bounces, row0=row0,
                    rows=self.chunk_rows)
                self.last_n_rays = self.last_n_rays + sample["n_rays"]
                stripe = ((rows >= row0) & (rows < row0 + self.chunk_rows))
                self.state = accumulate(
                    self.state, sample,
                    done=int(row0 + self.chunk_rows == self.height),
                    count=stripe.to(torch.float32))
        self.samples += 1

    @timed
    def run_adaptive_sample(self, fraction: float = 0.25):
        """One BDPT sample for only the highest-variance ``fraction`` of
        pixels, chosen from the accumulated per-pixel statistics (run a few
        uniform samples first so that they exist).  Unbiased: the display
        normalisation is weight-based, and the unidirectional image divides
        by per-pixel counts.  A striped renderer renders the selection in
        batches of ``chunk_rows * width`` pixels, the batch index folded
        into the key, and accumulates their sum as one sample."""
        n_select = max(1, int(self.width * self.height * fraction))
        sel = adaptive_select(self.state, n_select)
        key = rng.fold_in(self.key, self.samples)
        if self.chunk_rows is None:
            sample = render_sample_subset(key, self.scene.data, sel,
                                          self.width, self.height,
                                          self.max_bounces)
        else:
            batch = self.chunk_rows * self.width
            sample = None
            for i, b0 in enumerate(range(0, n_select, batch)):
                part = render_sample_subset(
                    rng.fold_in(key, i), self.scene.data, sel[b0:b0 + batch],
                    self.width, self.height, self.max_bounces)
                # the selected pixels are distinct, so batches touch
                # disjoint pixels and their sum carries one sample's stats
                sample = part if sample is None else {
                    k: sample[k] + part[k] for k in part}
        self.last_n_rays = sample["n_rays"]
        self.state = accumulate(self.state, sample,
                                count=sample["uni_count"])
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
    def unweighted_image(self) -> np.ndarray:
        img = self._host("summed_image")
        return tone_map(np.nan_to_num(img, posinf=0, neginf=0), exposure=4.0)

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
