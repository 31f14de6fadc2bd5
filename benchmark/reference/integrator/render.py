"""One BDPT sample over the whole frame (frozen copy of
clive2_tpu_torch/integrator/render.py for whole frames; stripes, tiles,
pixel subsets and the environment's knobs are left out): ray generation, one merged camera+light subpath trace,
BDPT connection with the splat scatter, the 3x3 filter, and the
accumulation of a sample into the renderer's state.

The wavefront's lane order is "raster" (lane i is pixel i) or "morton":
the camera wavefront in 2D Morton pixel order, the light wavefront sorted
by ``light_gen_key``, the images assembled by pixel.  Under morton the
light subpaths go back to their generation order before the connection
(``pair_lights``).  The program takes morton for every scene with a
traversal table and raster for the brute scenes; ``wave_order`` says
which, and it decides the random numbers each lane draws.
"""

from __future__ import annotations

import functools
import numpy as np
import torch

from .. import rng
from ..constants import MAX_BOUNCES
from ..ops.filters import (
    filter_weights,
    finalize_samples,
    finalize_samples_scatter,
)
from ..ops.intersect import ray_order
from .connect import connect_paths
from .trace import (
    generate_camera_rays,
    generate_light_rays,
    light_gen_key,
    trace_subpaths,
    unidirectional_image,
)

WAVE_ORDERS = ("auto", "raster", "morton")


@functools.lru_cache(maxsize=8)
def _morton_codes(rows: int, width: int):
    """2D Morton code of each raster lane of a rows x width grid, flat."""
    yy, xx = np.mgrid[0:rows, 0:width]

    def spread(v):                     # 16 bits to the even bits of 32
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return ((spread(yy) << 1) | spread(xx)).reshape(-1)


@functools.lru_cache(maxsize=16)
def _lane_morton_perm(rows: int, width: int, first: int, count: int):
    """Lanes [first, first + count) of a rows x width raster grid in Morton
    order: [count] int32 indices into that range."""
    code = _morton_codes(rows, width)[first:first + count]
    return np.argsort(code, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=8)
def _perm_on(rows: int, width: int, first: int, count: int, device):
    return torch.as_tensor(_lane_morton_perm(rows, width, first, count),
                           dtype=torch.int64, device=device)


def wave_order(scene) -> str:
    """The program's order for the scene: raster for a brute scene, morton
    for every other."""
    return "raster" if "brute" in scene else "morton"


def pair_lights(lorder, light_path):
    """The light subpaths, traced in the order ``lorder`` gave, put back in
    generation order: lane j then pairs camera lane j with the light ray
    generated at lane j, independent of the pixel that lane holds.  The JAX
    package pairs in sorted order: its pixel at Morton lane j always meets
    the j-th smallest ``light_gen_key`` of the wavefront, so each pixel
    connects to one part of the emitter every sample, and its light
    strategies converge to a different value per pixel block."""
    def back(v, dim=1):
        return torch.empty_like(v).index_copy_(dim, lorder, v)

    return dict(
        vertices={k: back(v) for k, v in light_path["vertices"].items()},
        valid=back(light_path["valid"]),
        length=back(light_path["length"], dim=0))


def trace_wavefront(key, scene, width, height,
                    max_bounces: int = MAX_BOUNCES, order: str = "raster"):
    """Camera rays for every pixel, as many light rays and one merged
    trace: the first stage of ``trace_and_connect``.  Returns
    dict(pixel_idx, sensor_pos, cam_path, light_path, n_rays: the
    extension rays cast); lane i of each is pixel ``pixel_idx[i]``."""
    if order not in ("raster", "morton"):
        raise ValueError(f"order={order!r}: expected raster or morton")
    cam = scene["camera"]
    k_cam, k_light, k_trace = rng.split(key, 3)
    cam_rays, pixel_idx = generate_camera_rays(k_cam, cam, width, height)
    n = pixel_idx.shape[0]
    light_rays = generate_light_rays(k_light, scene["lights"], scene["mat"],
                                     n)
    if order == "morton":
        perm = _perm_on(height, width, 0, n, key.device)
        cam_rays = {k: v[perm] for k, v in cam_rays.items()}
        pixel_idx = pixel_idx[perm]
        lo, hi = (light_rays["origin"].amin(0),
                  light_rays["origin"].amax(0))
        lorder = ray_order(light_gen_key(
            light_rays["origin"], light_rays["direction"], lo, hi))
        light_rays = {k: v[lorder] for k, v in light_rays.items()}
    sensor_pos = cam_rays["origin"]

    # camera and light wavefronts trace as ONE merged wavefront (per-ray
    # from_camera flag): one intersection call per depth
    merged = {k: torch.cat([cam_rays[k], light_rays[k]]) for k in cam_rays}
    del cam_rays, light_rays
    fc = torch.cat([torch.ones(n, dtype=torch.bool, device=key.device),
                    torch.zeros(n, dtype=torch.bool, device=key.device)])
    path = trace_subpaths(k_trace, merged, scene, from_camera=fc,
                          max_bounces=max_bounces)
    del merged
    cam_path = dict(
        vertices={k: v[:, :n] for k, v in path["vertices"].items()},
        valid=path["valid"][:, :n],
        length=path["length"][:n],
    )
    light_path = dict(
        vertices={k: v[:, n:] for k, v in path["vertices"].items()},
        valid=path["valid"][:, n:],
        length=path["length"][n:],
    )
    if order == "morton":
        light_path = pair_lights(lorder, light_path)
    return dict(pixel_idx=pixel_idx, sensor_pos=sensor_pos,
                cam_path=cam_path, light_path=light_path,
                n_rays=path["n_rays"])


def _finish(image, wimage, uni, conn, n_rays):
    return dict(
        image=torch.nan_to_num(image + conn["light_image"], posinf=0.0,
                               neginf=0.0),
        weight=wimage + conn["light_weight_image"],
        unidirectional=torch.nan_to_num(uni, posinf=0.0, neginf=0.0),
        n_rays=n_rays)


def render_sample(key, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES, order: str = None):
    """One full BDPT sample of the frame; ``key`` is a threefry key
    (``rng``), ``order`` the wavefront order (``wave_order(scene)`` when
    None).  Returns dict(image [H, W, 3], weight [H, W], unidirectional
    [H, W, 3], n_rays); display = sum(image) / sum(weight) over samples.
    """
    order = wave_order(scene) if order is None else order
    w = trace_wavefront(key, scene, width, height, max_bounces, order)
    conn = connect_paths(w["cam_path"], w["light_path"], scene, width,
                         height, max_bounces=max_bounces)
    weights = filter_weights(w["sensor_pos"], w["pixel_idx"],
                             scene["camera"], width, height)
    n_rays = w["n_rays"] + conn["n_rays"]
    uni = unidirectional_image(w["cam_path"])
    if order == "morton":
        # lanes hold pixels in any order: assemble by pixel
        image, wimage = finalize_samples_scatter(
            conn["contribution"], weights, conn["contrib_weight_sum"],
            w["pixel_idx"], width, height)
        uni = uni.new_zeros(height * width, 3).index_add_(
            0, w["pixel_idx"].long(), uni).reshape(height, width, 3)
        return _finish(image, wimage, uni, conn, n_rays)
    image, wimage = finalize_samples(
        conn["contribution"], weights, conn["contrib_weight_sum"], width,
        height)
    return _finish(image, wimage, uni.reshape(height, width, 3), conn,
                   n_rays)


def accumulate(state, sample, done=1, count=1.0):
    """Running accumulation of one sample (or one stripe or subset batch of
    it) into the state.  ``done``: samples this completes (0 for a stripe
    before the last); ``count``: per-pixel samples it adds to
    ``pixel_count`` (a scalar, or a tensor that broadcasts to [H, W])."""
    return dict(
        summed_image=state["summed_image"] + sample["image"],
        summed_weight=state["summed_weight"] + sample["weight"],
        summed_unidirectional=state["summed_unidirectional"]
        + sample["unidirectional"],
        n_samples=state["n_samples"] + done,
        summed_sq=state["summed_sq"] + sample_luma_sq(sample),
        pixel_count=state["pixel_count"] + count,
    )


def sample_luma_sq(sample):
    """Squared luma of one sample's count-normalised pixel estimate."""
    val = sample["image"] / torch.clamp(sample["weight"], min=1e-6)[..., None]
    luma = val.mean(-1)
    return luma * luma
