"""One BDPT sample for every pixel (port of clive2_tpu/integrator/render.py,
raster wavefront order): ray generation, one merged camera+light subpath
trace, BDPT connection with the splat scatter, and the 3x3 filter.
"""

from __future__ import annotations

import torch

from .. import rng
from ..constants import MAX_BOUNCES
from ..ops.filters import filter_weights, finalize_samples
from .connect import connect_paths
from .trace import (
    generate_camera_rays,
    generate_light_rays,
    trace_subpaths,
    unidirectional_image,
)


def render_sample(key, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES):
    """One full BDPT sample; ``key`` is a threefry key (``rng``).

    Returns dict(image [H, W, 3], weight [H, W], unidirectional [H, W, 3],
    n_rays).  ``image``/``weight`` follow the accumulation contract:
    display = sum(image) / sum(weight) over samples.
    """
    cam = scene["camera"]
    k_cam, k_light, k_trace = rng.split(key, 3)

    cam_rays, pixel_idx = generate_camera_rays(k_cam, cam, width, height)
    n = width * height
    light_rays = generate_light_rays(k_light, scene["lights"], scene["mat"],
                                     n)
    sensor_pos = cam_rays["origin"]

    # camera and light wavefronts trace as ONE merged wavefront (per-ray
    # from_camera flag): one intersection call per depth
    merged = {k: torch.cat([cam_rays[k], light_rays[k]]) for k in cam_rays}
    del light_rays
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

    uni = unidirectional_image(cam_path)
    conn = connect_paths(cam_path, light_path, scene, width, height,
                         max_bounces=max_bounces)
    n_rays = path["n_rays"] + conn["n_rays"]
    del path, cam_path, light_path

    weights = filter_weights(sensor_pos, pixel_idx, cam, width, height)
    image, wimage = finalize_samples(
        conn["contribution"], weights, conn["contrib_weight_sum"],
        width, height)

    total_image = image + conn["light_image"]
    total_weight = wimage + conn["light_weight_image"]
    return dict(
        image=torch.nan_to_num(total_image, posinf=0.0, neginf=0.0),
        weight=total_weight,
        unidirectional=torch.nan_to_num(uni.reshape(height, width, 3),
                                        posinf=0.0, neginf=0.0),
        n_rays=n_rays,
    )


def accumulate(state, sample):
    """Running accumulation of one sample into the state."""
    return dict(
        summed_image=state["summed_image"] + sample["image"],
        summed_weight=state["summed_weight"] + sample["weight"],
        summed_unidirectional=state["summed_unidirectional"]
        + sample["unidirectional"],
        n_samples=state["n_samples"] + 1,
        summed_sq=state["summed_sq"] + sample_luma_sq(sample),
        pixel_count=state["pixel_count"] + 1.0,
    )


def init_accumulators(width: int, height: int, device="cpu"):
    z = lambda *shape: torch.zeros(shape, device=device)
    return dict(
        summed_image=z(height, width, 3),
        summed_weight=z(height, width),
        summed_unidirectional=z(height, width, 3),
        n_samples=torch.zeros((), dtype=torch.int32, device=device),
        # per-pixel sample counts and the running sum of squared per-sample
        # luma estimates (the variance guide of adaptive sampling)
        summed_sq=z(height, width),
        pixel_count=z(height, width),
    )


def sample_luma_sq(sample):
    """Squared luma of one sample's count-normalised pixel estimate."""
    val = sample["image"] / torch.clamp(sample["weight"], min=1e-6)[..., None]
    luma = val.mean(-1)
    return luma * luma
