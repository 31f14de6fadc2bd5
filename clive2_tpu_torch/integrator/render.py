"""One BDPT sample (port of clive2_tpu/integrator/render.py, raster
wavefront order): ray generation, one merged camera+light subpath trace,
BDPT connection with the splat scatter, and the 3x3 filter, for every pixel,
an image stripe or an arbitrary pixel subset.
"""

from __future__ import annotations

import torch

from .. import rng
from ..constants import MAX_BOUNCES
from ..ops.filters import (
    filter_weights,
    finalize_samples,
    finalize_samples_scatter,
)
from .connect import connect_paths
from .trace import (
    generate_camera_rays,
    generate_light_rays,
    trace_subpaths,
    unidirectional_image,
)


def trace_and_connect(key, scene, width, height,
                      max_bounces: int = MAX_BOUNCES,
                      debug_per_strategy: bool = False, **select):
    """Camera rays for the pixels ``select`` names (a stripe's row0/rows or
    a pixel_sel subset; every pixel when empty), as many light rays, one
    merged trace and the connection.  Returns (pixel_idx, filter weights,
    camera path, connection outputs, n_rays)."""
    cam = scene["camera"]
    k_cam, k_light, k_trace = rng.split(key, 3)

    cam_rays, pixel_idx = generate_camera_rays(k_cam, cam, width, height,
                                               **select)
    n = pixel_idx.shape[0]
    light_rays = generate_light_rays(k_light, scene["lights"], scene["mat"],
                                     n)
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

    conn = connect_paths(cam_path, light_path, scene, width, height,
                         max_bounces=max_bounces,
                         debug_per_strategy=debug_per_strategy)
    weights = filter_weights(sensor_pos, pixel_idx, cam, width, height)
    return pixel_idx, weights, cam_path, conn, path["n_rays"] + conn["n_rays"]


def _finish(image, wimage, uni, conn, n_rays, **extra):
    return dict(
        image=torch.nan_to_num(image + conn["light_image"], posinf=0.0,
                               neginf=0.0),
        weight=wimage + conn["light_weight_image"],
        unidirectional=torch.nan_to_num(uni, posinf=0.0, neginf=0.0),
        n_rays=n_rays, **extra)


def render_sample(key, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES, row0: int = None,
                  rows: int = None):
    """One full BDPT sample; ``key`` is a threefry key (``rng``).

    ``row0``/``rows`` render only an image stripe: the outputs are still
    full-size [H, W] images, zero outside the stripe and its filter's
    one-row spill, except the splat image, which a stripe's light subpaths
    write anywhere.  The outputs summed over a partition into stripes form
    one sample of the frame.

    Returns dict(image [H, W, 3], weight [H, W], unidirectional [H, W, 3],
    n_rays).  ``image``/``weight`` follow the accumulation contract:
    display = sum(image) / sum(weight) over samples.
    """
    stripe = rows is not None and rows != height
    row0 = 0 if row0 is None else int(row0)
    local = rows if stripe else height
    _, weights, cam_path, conn, n_rays = trace_and_connect(
        key, scene, width, height, max_bounces, row0=row0, rows=local)
    uni = unidirectional_image(cam_path)
    del cam_path
    image, wimage = finalize_samples(
        conn["contribution"], weights, conn["contrib_weight_sum"],
        width, height, row0=row0 if stripe else None,
        rows=rows if stripe else None)
    uni = uni.reshape(local, width, 3)
    if stripe:
        uni = torch.cat([uni.new_zeros(row0, width, 3), uni,
                         uni.new_zeros(height - row0 - rows, width, 3)])
    return _finish(image, wimage, uni, conn, n_rays)


def render_sample_subset(key, scene, pixel_sel, width: int, height: int,
                         max_bounces: int = MAX_BOUNCES):
    """One BDPT sample for an arbitrary pixel subset (adaptive sampling).

    ``pixel_sel``: [M] int flat pixel indices (may repeat).  Outputs are
    full-size [H, W] images, zero away from the selected pixels and their
    filter footprints except the splat image; ``uni_count`` [H, W] counts
    the samples each pixel's unidirectional image received.
    """
    pixel_idx, weights, cam_path, conn, n_rays = trace_and_connect(
        key, scene, width, height, max_bounces, pixel_sel=pixel_sel)
    uni_vals = unidirectional_image(cam_path)
    del cam_path
    image, wimage = finalize_samples_scatter(
        conn["contribution"], weights, conn["contrib_weight_sum"],
        pixel_idx, width, height)
    pix = pixel_idx.long()
    uni = uni_vals.new_zeros(height * width, 3).index_add_(0, pix, uni_vals)
    uni_count = uni_vals.new_zeros(height * width).index_add_(
        0, pix, torch.ones_like(uni_vals[:, 0]))
    return _finish(image, wimage, uni.reshape(height, width, 3), conn,
                   n_rays, uni_count=uni_count.reshape(height, width))


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
