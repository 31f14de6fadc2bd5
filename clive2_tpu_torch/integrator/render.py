"""One BDPT sample (port of clive2_tpu/integrator/render.py): ray
generation, one merged camera+light subpath trace, BDPT connection with the
splat scatter, and the 3x3 filter, for every pixel, an image stripe or an
arbitrary pixel subset; and the step that renders a sample over a tile mesh
(``make_sharded_render``), each rank a band of rows, the outputs summed
across ranks.

The wavefront's lane order (``_wave_order``, ``CLIVE2_WAVE_ORDER``) is
"raster" (lane i is pixel i) or "morton": the camera wavefront in 2D Morton
pixel order, the light wavefront sorted by ``light_gen_key``, both for ray
coherence in the traversals, and the images assembled by pixel.  Under
morton the light subpaths go back to their generation order before the
connection, so that each camera lane pairs with an independent light
subpath; the JAX package pairs them in sorted order, which ties every
pixel to the same rank of the light wavefront's key (see ``pair_lights``).
"""

from __future__ import annotations

import functools
import os

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
    sort_knob,
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


def _morton_pixel_perm(rows: int, width: int):
    """The permutation that puts a rows x width raster grid in 2D Morton
    order."""
    return _lane_morton_perm(rows, width, 0, rows * width)


def _banded_morton_perm(rows: int, width: int, bands: int):
    """Each of ``bands`` equal lane ranges of the grid in Morton order, in
    place: [bands, N // bands] indices into each range (the layout of a
    wavefront split over ``bands`` devices)."""
    per = rows * width // bands
    return np.stack([_lane_morton_perm(rows, width, b * per, per)
                     for b in range(bands)])


@functools.lru_cache(maxsize=8)
def _perm_on(rows: int, width: int, first: int, count: int, device):
    return torch.as_tensor(_lane_morton_perm(rows, width, first, count),
                           dtype=torch.int64, device=device)


def _wave_order(scene, mesh=None) -> str:
    """The wavefront order policy: ``CLIVE2_WAVE_ORDER`` in {auto, raster,
    morton}, read at call time.  auto, as the JAX package decides it
    without its tuned defaults: morton for a scene with a traversal table
    (``stream``, ``stream2``, ``bvh2``, ``wide``), raster for the brute
    scenes and the gather walk.  A tile mesh takes the same policy (each
    rank's band in Morton order in place); ``make_sharded_render`` falls
    back to raster when its tiles differ in rows.  Unlike the JAX package,
    an unknown value raises."""
    v = os.environ.get("CLIVE2_WAVE_ORDER", "auto") or "auto"
    if v not in WAVE_ORDERS:
        raise ValueError(f"CLIVE2_WAVE_ORDER={v!r}: expected one of "
                         f"{', '.join(WAVE_ORDERS)}")
    if v != "auto":
        return v
    tables = ("stream", "stream2", "bvh2", "wide")
    return "morton" if any(t in scene for t in tables) else "raster"


def cast_sorts(scene, order: str):
    """(trace, connect) sort policies of a sample in ``order``.  Under
    morton, as in the JAX package: the extension casts of the streaming
    tables still sort per cast (bounces scramble the inherited order) and
    those of the others do not; connection casts do not sort; an explicit
    ``CLIVE2_TRACE_SORT`` or ``CLIVE2_CONNECT_SORT`` wins.  Under raster
    both follow the knobs and ``intersect_scene``'s default."""
    if order != "morton":
        return None, None
    streaming = "stream" in scene or "stream2" in scene
    trace = (None if streaming else False) \
        if sort_knob("CLIVE2_TRACE_SORT") is None else None
    connect = False if sort_knob("CLIVE2_CONNECT_SORT") is None else None
    return trace, connect


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


def trace_and_connect(key, scene, width, height,
                      max_bounces: int = MAX_BOUNCES,
                      debug_per_strategy: bool = False, tile=None,
                      order: str = "raster", light_bounds=None, **select):
    """Camera rays for the pixels ``select`` names (a stripe's row0/rows or
    a pixel_sel subset; every pixel when empty), as many light rays, one
    merged trace and the connection.  ``tile=(t0, t_rows)`` traces only
    image rows [t0, t0 + t_rows) of the frame or stripe, each lane drawing
    the random numbers of its own lane in the frame's (stripe's) draws.

    ``order="morton"`` (whole frames, stripes and tiles) traces the camera
    rays in Morton order over the frame's (stripe's) grid, a tile's in
    place, and the light rays sorted by ``light_gen_key`` over the
    wavefront's bounds, or over ``light_bounds(lo, hi)`` of the tile's own
    (a mesh's bounds over every rank); lanes keep their draws.  Returns
    (pixel_idx, filter weights, camera path, connection outputs, n_rays):
    lane i of each is pixel ``pixel_idx[i]``."""
    if order not in ("raster", "morton"):
        raise ValueError(f"order={order!r}: expected raster or morton")
    if order == "morton" and (debug_per_strategy or "pixel_sel" in select):
        raise ValueError("per-strategy images and pixel subsets are "
                         "raster only")
    cam = scene["camera"]
    k_cam, k_light, k_trace = rng.split(key, 3)
    lanes = merged_lanes = None
    win_rows = int(select.get("rows", height))
    first = 0
    if tile is not None:
        if debug_per_strategy or "pixel_sel" in select:
            raise ValueError("a tile renders a band of rows of whole-frame "
                             "images: no per-strategy images, no subsets")
        win0 = int(select.get("row0", 0))
        t0, t_rows = int(tile[0]), int(tile[1])
        if not win0 <= t0 <= t0 + t_rows <= win0 + win_rows:
            raise ValueError(f"tile rows [{t0}, {t0 + t_rows}) are not "
                             f"inside [{win0}, {win0 + win_rows})")
        first = (t0 - win0) * width
        lanes = torch.arange(first, first + t_rows * width,
                             device=key.device)
        # the merged draw's light half starts at the frame's (stripe's)
        # lane count, not at the tile's
        merged_lanes = torch.cat([lanes, lanes + win_rows * width])
        select = dict(row0=t0, rows=t_rows)

    cam_rays, pixel_idx = generate_camera_rays(k_cam, cam, width, height,
                                               lanes=lanes, **select)
    n = pixel_idx.shape[0]
    light_rays = generate_light_rays(k_light, scene["lights"], scene["mat"],
                                     n, lanes=lanes)
    trace_sort, connect_sort = cast_sorts(scene, order)
    if order == "morton":
        perm = _perm_on(win_rows, width, first, n, key.device)
        cam_rays = {k: v[perm] for k, v in cam_rays.items()}
        pixel_idx = pixel_idx[perm]
        lo, hi = (light_rays["origin"].amin(0),
                  light_rays["origin"].amax(0))
        if light_bounds is not None:
            lo, hi = light_bounds(lo, hi)
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
                          max_bounces=max_bounces, lanes=merged_lanes,
                          sort=trace_sort)
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

    conn = connect_paths(cam_path, light_path, scene, width, height,
                         max_bounces=max_bounces,
                         debug_per_strategy=debug_per_strategy,
                         sort=connect_sort)
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
                  rows: int = None, tile=None, order: str = None,
                  light_bounds=None):
    """One full BDPT sample; ``key`` is a threefry key (``rng``).

    ``row0``/``rows`` render only an image stripe: the outputs are still
    full-size [H, W] images, zero outside the stripe and its filter's
    one-row spill, except the splat image, which a stripe's light subpaths
    write anywhere.  The outputs summed over a partition into stripes form
    one sample of the frame.  A stripe draws its own random numbers.

    ``tile=(t0, t_rows)`` renders only image rows [t0, t0 + t_rows) of the
    frame (or of the stripe), with the random numbers those rows' lanes
    draw in the frame's (stripe's) sample: in raster order the outputs
    summed over a partition of its rows into tiles equal the frame's
    (stripe's) sample, up to the order of float sums.

    ``order``: the wavefront order, ``_wave_order(scene)`` when None;
    ``light_bounds`` as in ``trace_and_connect``.

    Returns dict(image [H, W, 3], weight [H, W], unidirectional [H, W, 3],
    n_rays).  ``image``/``weight`` follow the accumulation contract:
    display = sum(image) / sum(weight) over samples.
    """
    stripe = rows is not None and rows != height
    row0 = 0 if row0 is None else int(row0)
    local = rows if stripe else height
    t0, t_rows = (row0, local) if tile is None else map(int, tile)
    order = _wave_order(scene) if order is None else order
    pixel_idx, weights, cam_path, conn, n_rays = trace_and_connect(
        key, scene, width, height, max_bounces, tile=tile, order=order,
        light_bounds=light_bounds, row0=row0, rows=local)
    uni = unidirectional_image(cam_path)
    del cam_path
    if order == "morton":
        # lanes hold pixels in any order: assemble by pixel
        image, wimage = finalize_samples_scatter(
            conn["contribution"], weights, conn["contrib_weight_sum"],
            pixel_idx, width, height)
        uni = uni.new_zeros(height * width, 3).index_add_(
            0, pixel_idx.long(), uni).reshape(height, width, 3)
        return _finish(image, wimage, uni, conn, n_rays)
    part = t_rows != height
    image, wimage = finalize_samples(
        conn["contribution"], weights, conn["contrib_weight_sum"],
        width, height, row0=t0 if part else None,
        rows=t_rows if part else None)
    uni = uni.reshape(t_rows, width, 3)
    if part:
        uni = torch.cat([uni.new_zeros(t0, width, 3), uni,
                         uni.new_zeros(height - t0 - t_rows, width, 3)])
    return _finish(image, wimage, uni, conn, n_rays)


def make_sharded_render(mesh, width: int, height: int,
                        max_bounces: int = MAX_BOUNCES):
    """The render step over a tile mesh (``parallel.mesh``):
    ``step(key, scene, row0=None, rows=None)`` renders this rank's band of
    the frame's rows (``tile_rows``; of the stripe's with ``row0``/
    ``rows``) with ``render_sample(tile=)``, then sums ``image``,
    ``weight``, ``unidirectional`` and ``n_rays`` over the ranks, so that
    every rank holds the frame's (stripe's) sample.  Under the morton
    order each band is Morton-ordered in place and sorts its light rays on
    bounds taken over every rank (the JAX package's banded layout); when
    the bands differ in rows, the step renders in raster order."""
    from ..parallel.mesh import tile_rows

    def step(key, scene, row0=None, rows=None):
        win0 = 0 if row0 is None else int(row0)
        win_rows = height if rows is None else int(rows)
        t0, t_rows = tile_rows(mesh, win_rows)
        order = _wave_order(scene, mesh)
        if win_rows % mesh.size:
            order = "raster"       # the banded layout needs equal bands
        if t_rows:
            sample = render_sample(key, scene, width, height, max_bounces,
                                   row0=win0, rows=win_rows,
                                   tile=(win0 + t0, t_rows), order=order,
                                   light_bounds=mesh.bounds)
        else:                      # more ranks than rows: nothing to trace
            z = lambda *shape: torch.zeros(shape, device=key.device)
            sample = dict(image=z(height, width, 3), weight=z(height, width),
                          unidirectional=z(height, width, 3),
                          n_rays=torch.zeros((), dtype=torch.int64,
                                             device=key.device))
        mesh.all_reduce_sum([sample[k] for k in (
            "image", "weight", "unidirectional", "n_rays")])
        return sample

    return step


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
