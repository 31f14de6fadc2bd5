"""The renderer's statistical oracles (the JAX package's
tests/test_convergence.py, test_convergence_glass.py and test_furnace.py),
computed with the port on any device.

These hold the whole MIS chain to an independent estimate without comparing
with the JAX package, so they do not depend on masking near ties:

* convergence: per 8x8 block, the count-normalised BDPT image of the
  transport classes k = t + s <= MAX_BOUNCES (built from the per-strategy
  images, ``connect_paths(debug_per_strategy=True)``) against the all-hits
  unidirectional image (``unidirectional_image(all_hits=True)``), which
  reaches the same classes; and the BDPT total, whose classes above
  MAX_BOUNCES the unidirectional image cannot reach, within a bound;
* glass convergence: the same strict comparison on a glass icosphere scene,
  where transmission, reflection and the specular zeroing of the chain run;
* furnace: in a closed room of Lambertian emitters of albedo RHO the
  per-class radiance falls by exactly RHO per bounce; in a black room of
  unit emitters a clear glass sphere is invisible (every pixel reads 1).

Each function returns its numbers; ``check`` holds them to the JAX tests'
bounds and raises ``AssertionError`` naming the bounds that fail.  The
samples are traced as whole frames, many to a wavefront (up to 2^20 lanes
on the card, 2^16 on the CPU), the key of wavefront b folded from the seed
key: the same sample counts as the JAX tests, in far fewer launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .constants import MAX_BOUNCES
from .geometry import TriangleSoup
from .integrator.render import trace_and_connect
from .integrator.trace import (
    generate_camera_rays,
    trace_subpaths,
    unidirectional_image,
)
from .materials import MaterialTable
from .models import icosphere
from .scene import create_scene, create_scene_from_preset

RHO = 0.7


def _blocks(im, blk):
    h, w, _ = im.shape
    return im.reshape(h // blk, blk, w // blk, blk, 3).mean(axis=(1, 3))


def _rel(b_b, b_u):
    """Per-block deviation relative to the pair's mean plus 5% of the
    image's mean (the JAX tests' measure)."""
    return (b_b - b_u) / (0.5 * (b_b + b_u) + 0.05 * b_u.mean())


def _wavefronts(scene, size, spp, seed):
    """(key, pixel_sel) of each wavefront: whole size x size frames, as many
    as fit, ``spp`` in all."""
    dev = scene.device
    per = max(1, (1 << (20 if dev.type == "cuda" else 16)) // (size * size))
    frame = torch.arange(size * size, dtype=torch.int32, device=dev)
    key = rng.key(seed, device=dev)
    for b, first in enumerate(range(0, spp, per)):
        yield rng.fold_in(key, b), frame.repeat(min(per, spp - first))


def _frames(x, size):
    """Per-lane values of a wavefront of whole frames, summed per pixel."""
    return x.reshape(-1, size, size, 3).sum(0)


def _class_limited(scene, size, spp, seed, total=False):
    """Mean over ``spp`` samples of the class-limited BDPT image, the
    all-hits unidirectional image and, with ``total``, the BDPT image of
    every class."""
    acc = {}
    for key, sel in _wavefronts(scene, size, spp, seed):
        _, _, cam_path, conn, _ = trace_and_connect(
            key, scene.data, size, size, debug_per_strategy=True,
            pixel_sel=sel)
        out = dict(
            limited=sum(d["weighted"] for (t, s), d in
                        conn["per_strategy"].items()
                        if t + s <= MAX_BOUNCES),
            uni=_frames(unidirectional_image(cam_path, all_hits=True), size))
        if total:
            out["total"] = sum(d["weighted"]
                               for d in conn["per_strategy"].values())
        acc = {k: acc.get(k, 0) + v for k, v in out.items()}
    return {k: (v / spp).cpu().numpy() for k, v in acc.items()}


def convergence(device, size=64, spp=256, blk=8, seed=123):
    """Cornell ``empty``: class-limited and total BDPT against the all-hits
    unidirectional image per ``blk`` x ``blk`` block."""
    scene = create_scene_from_preset("empty", size, size, device=device)
    im = _class_limited(scene, size, spp, seed, total=True)
    b_u = _blocks(im["uni"], blk)
    b_l, b_t = _blocks(im["limited"], blk), _blocks(im["total"], blk)
    rel_l, rel_t = _rel(b_l, b_u), _rel(b_t, b_u)
    return dict(size=size, spp=spp, uni_mean=float(b_u.mean()),
                strict_rel_max=float(np.abs(rel_l).max()),
                strict_ratio=float(b_l.mean() / b_u.mean()),
                total_ratio=float(b_t.mean() / b_u.mean()),
                total_rel_min=float(rel_t.min()),
                total_rel_max=float(rel_t.max()))


def glass_scene(size, device):
    """The Cornell room with an 80-triangle glass icosphere (material 5),
    small enough for the brute-force intersector."""
    v, f = icosphere(1)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.6 + np.array([0.0, 0.6, 1.0])).astype(np.float32),
        material=5)
    return create_scene(pixel_width=size, pixel_height=size,
                        cam_center=np.array([0, 1.5, 6]),
                        cam_direction=np.array([0, 0, -1.0]),
                        extra_geometry=soup, device=device)


def glass_convergence(device, size=48, spp=256, blk=8, seed=321):
    """The strict convergence comparison on the glass scene."""
    scene = glass_scene(size, device)
    im = _class_limited(scene, size, spp, seed)
    b_l, b_u = _blocks(im["limited"], blk), _blocks(im["uni"], blk)
    return dict(size=size, spp=spp, brute="brute" in scene.data,
                uni_mean=float(b_u.mean()),
                rel_max=float(np.abs(_rel(b_l, b_u)).max()),
                ratio=float(b_l.mean() / b_u.mean()))


def _camera_paths(scene, size, spp, seed, max_bounces):
    """Camera subpaths of ``spp`` whole frames, one wavefront at a time."""
    for key, sel in _wavefronts(scene, size, spp, seed):
        k_cam, k_trace = rng.split(key, 2)
        cam_rays, _ = generate_camera_rays(k_cam, scene.data["camera"], size,
                                           size, pixel_sel=sel)
        yield trace_subpaths(k_trace, cam_rays, scene.data, from_camera=True,
                             max_bounces=max_bounces)


def furnace(device, size=32, spp=96, seed=11):
    """Every wall a Lambertian emitter (E = 1) of albedo RHO: the mean
    unidirectional estimate per transport class (index d: class d + 1) and
    the ratios of consecutive classes, which must equal RHO."""
    def all_emissive(soup):
        soup.is_light = ~soup.is_camera
        soup.material = np.where(soup.is_camera, 7, 6).astype(np.int32)
        return soup

    mats = MaterialTable.build(
        [dict(color=(RHO, RHO, RHO))] * 6
        + [dict(color=(RHO, RHO, RHO), emission=(1.0, 1.0, 1.0))]
        + [dict(color=(1.0, 1.0, 1.0))])          # slot 7: sensor plane
    scene = create_scene(pixel_width=size, pixel_height=size,
                         cam_center=np.array([0, 1.5, 6]),
                         cam_direction=np.array([0, 0, -1]), materials=mats,
                         soup_transform=all_emissive, device=device)
    sums = torch.zeros(MAX_BOUNCES, dtype=torch.float64, device=scene.device)
    for path in _camera_paths(scene, size, spp, seed, MAX_BOUNCES):
        v = path["vertices"]
        mask = path["valid"] & (v["hit_light"] >= 0)
        color = v["color"]
        prior = torch.cat([torch.ones_like(color[:1]), color[:-1]])
        est = prior.mean(-1) / torch.clamp(v["tot_importance"], min=1e-30)
        sums += torch.where(mask, est, 0.0).sum(1)
    means = (sums / (spp * size * size)).cpu().numpy()
    return dict(size=size, spp=spp, class_means=means.tolist(),
                ratios=(means[2:] / means[1:-1]).tolist())


def glass_furnace(device, size=32, spp=96, seed=5, max_bounces=12):
    """A clear glass sphere (color 1, ior 1.5) in a black room of unit
    emitters, traced to ``max_bounces`` vertices: per-pixel luminance of the
    all-hits unidirectional image, which must read 1 everywhere, less
    deep-TIR truncation."""
    def walls_emissive(soup):
        is_glass = soup.material == 0
        soup.is_light = ~soup.is_camera & ~is_glass
        soup.material = np.where(soup.is_camera, 7,
                                 np.where(is_glass, 0, 6)).astype(np.int32)
        return soup

    mats = MaterialTable.build(
        [dict(color=(1.0, 1.0, 1.0), type=1, ior=1.5)]
        + [dict(color=(0.0, 0.0, 0.0))] * 5
        + [dict(color=(0.0, 0.0, 0.0), emission=(1.0, 1.0, 1.0))]
        + [dict(color=(1.0, 1.0, 1.0))])
    v, f = icosphere(1)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.5 + np.array([0.0, 1.5, 1.5])).astype(np.float32),
        material=0)
    scene = create_scene(pixel_width=size, pixel_height=size,
                         cam_center=np.array([0, 1.5, 6]),
                         cam_direction=np.array([0, 0, -1]), materials=mats,
                         extra_geometry=soup, soup_transform=walls_emissive,
                         device=device)
    img = sum(_frames(unidirectional_image(path, all_hits=True), size)
              for path in _camera_paths(scene, size, spp, seed, max_bounces))
    lum = (img / spp).mean(-1).cpu().numpy()
    h = size // 2
    return dict(size=size, spp=spp, max_bounces=max_bounces,
                mean=float(lum.mean()), min=float(lum.min()),
                max=float(lum.max()),
                center=float(lum[h - 4:h + 4, h - 4:h + 4].mean()),
                background=float(lum[:6, :6].mean()))


# the JAX tests' bounds: (oracle, what, predicate on its numbers)
BOUNDS = (
    ("convergence", "strict: block |rel| max < 0.12",
     lambda r: r["strict_rel_max"] < 0.12),
    ("convergence", "strict: |global ratio - 1| < 0.03",
     lambda r: abs(r["strict_ratio"] - 1.0) < 0.03),
    ("convergence", "total: 1.00 <= global ratio < 1.12",
     lambda r: 1.00 <= r["total_ratio"] < 1.12),
    ("convergence", "total: block rel min > -0.12",
     lambda r: r["total_rel_min"] > -0.12),
    ("convergence", "total: block rel max < 0.30",
     lambda r: r["total_rel_max"] < 0.30),
    ("glass_convergence", "block |rel| max < 0.18",
     lambda r: r["rel_max"] < 0.18),
    ("glass_convergence", "|global ratio - 1| < 0.04",
     lambda r: abs(r["ratio"] - 1.0) < 0.04),
    ("furnace", "class 1 is zero and class 2 positive",
     lambda r: r["class_means"][0] == 0 and r["class_means"][1] > 0),
    ("furnace", "every class ratio within 0.02 of RHO",
     lambda r: all(abs(x - RHO) < 0.02 for x in r["ratios"])),
    ("glass_furnace", "|mean - 1| < 0.02",
     lambda r: abs(r["mean"] - 1.0) < 0.02),
    ("glass_furnace", "max < 1.05", lambda r: r["max"] < 1.05),
    ("glass_furnace", "min > 0.70", lambda r: r["min"] > 0.70),
    ("glass_furnace", "|center - background| < 0.08",
     lambda r: abs(r["center"] - r["background"]) < 0.08),
)


def check(oracle, numbers, only=None):
    """Hold ``numbers`` (from the function named ``oracle``) to its bounds,
    or to those whose text starts with ``only``; raise AssertionError
    naming every bound that fails."""
    failed = [what for name, what, ok in BOUNDS
              if name == oracle and what.startswith(only or "")
              and not ok(numbers)]
    if failed:
        raise AssertionError(f"{oracle}: {failed} failed; {numbers}")
