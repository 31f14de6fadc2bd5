"""The large-scene path end to end against the JAX package on the CPU.

The icosphere BVH scene of tests/test_torch_slice.py (334 triangles) is
built with ``STREAM2_MIN_TRIS`` lowered, so the port takes its ``stream2``
table and ``stream2_plain`` carries every cast of the sample.  The JAX
package renders the same scene with its gather walk, since it packs stream2
only on a TPU.  One sample is compared at the golden tolerance outside
near-tie pixels (tests/torch_parity.py), the unidirectional image on every
pixel.  The fat-leaf test reorders the Möller-Trumbore arithmetic, so its
near ties differ from the gather walk's: measured 3 differing rays over the
sample's 7 casts (12,288 rays), reaching 11% of the pixels, where the
gather-walk port measures 0 on this scene; the bound is about 3x that.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from clive2_tpu_torch.geometry import box_geometry, camera_geometry
from clive2_tpu_torch.materials import default_materials
from clive2_tpu_torch.ops import intersect, traverse_stream2
from test_torch_slice import FIELDS, SEED, H, W, _bvh_scene
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

MAX_DIFFERING_RAYS = 10       # about 3x the measured 3


@pytest.fixture(scope="module")
def sample():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
        ts = _bvh_scene(ct, TorchSoup, device="cpu")
    js = _bvh_scene(c2, JaxSoup)
    assert "stream2" in ts.data and "bvh2" not in ts.data
    jax_renderer._make_step.cache_clear()    # trace anew, with recording
    jax.clear_caches()
    jr = c2.Renderer(js, seed=SEED)
    tr = ct.Renderer(ts, seed=SEED)
    calls = traverse_stream2.stream2_plain.calls
    walks = intersect.intersect_bvh_packed.calls
    # the JAX package's CPU scene has no traversal table and renders in
    # raster order; with one, the port's default order would be morton
    with NearTies() as ties, pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIVE2_WAVE_ORDER", "raster")
        jr.run_sample()
        tr.run_sample()
    return dict(
        ties=ties,
        plain_calls=traverse_stream2.stream2_plain.calls - calls,
        walk_calls=intersect.intersect_bvh_packed.calls - walks,
        want={k: np.asarray(jr.state[k]) for k in FIELDS},
        got={k: tr.state[k].numpy() for k in FIELDS})


def test_stream2_carries_every_cast(sample):
    assert sample["plain_calls"] == 7          # 6 extension + 1 connection
    assert sample["walk_calls"] == 0


def test_stream2_sample_matches_jax(sample):
    counts = sample["ties"].differing_rays()
    assert max(counts) <= MAX_DIFFERING_RAYS, counts
    near = check_ties(sample["ties"], W, H, samples=[0])
    for k in FIELDS:
        mask = np.zeros_like(near) if k == "summed_unidirectional" else near
        assert_match(sample["got"][k], sample["want"][k], mask, k)
    assert sample["got"]["summed_image"].mean() > 0


@pytest.mark.parametrize("threshold,want", [(0, "stream2"), (1, "bvh2")])
def test_dispatch_threshold(monkeypatch, threshold, want):
    """At or above STREAM2_MIN_TRIS world triangles a scene gets the
    stream2 table and no bvh2 table, on the CPU and for CUDA alike; below
    it, CUDA scenes get bvh2 (``threshold`` is the triangle count the
    limit sits above the scene's)."""
    rng = np.random.default_rng(40)
    mesh = TorchSoup.from_vertices(
        (rng.uniform(-1, 1, (300, 1, 3)) + rng.uniform(-0.2, 0.2, (300, 3, 3))
         ).astype(np.float32))
    cam = ct.create_scene(pixel_width=4, pixel_height=4, device="cpu").camera
    soup = camera_geometry(cam) + box_geometry() + mesh
    n_world = int((~soup.is_camera).sum())
    monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", n_world + threshold)
    for cuda in (True, False):
        data, _, _ = port_scene._build_scene_arrays(
            soup, default_materials(), cam, cuda=cuda)
        other = {"stream2": "bvh2", "bvh2": "stream2"}[want]
        assert other not in data
        assert (want in data) == (cuda or want == "stream2")


def test_cast_log_finds_where_two_routes_differ(monkeypatch):
    """``testing.CastLog`` (chip_smoke's gate between big-dragon's two
    routes) on the CPU: the icosphere scene rendered on the gather walk and
    on stream2 tables, both in Morton order, one sample each.  Each log
    holds the sample's 7 casts, 6 splat arrays and one lane map; outside
    the pixels the differing casts reach the two images match at the
    golden tolerance, and a log against itself differs nowhere."""
    from clive2_tpu_torch.testing import CastLog

    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "morton")
    walk = _bvh_scene(ct, TorchSoup, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
        fat = _bvh_scene(ct, TorchSoup, device="cpu")
    assert "stream2" in fat.data and "stream2" not in walk.data
    logs, states = [], []
    for scene in (walk, fat):
        r = ct.Renderer(scene, seed=SEED)
        with CastLog() as log:
            r.run_sample()
        logs.append(log)
        states.append({k: r.state[k].numpy() for k in FIELDS})
    for log in logs:
        assert (len(log.casts), len(log.splats), len(log.pixels)) == (7, 6, 1)
        assert log.light_orders[0] is not None
    near, rays = logs[0].near(logs[1], 0, W, H)
    assert rays <= MAX_DIFFERING_RAYS and near.mean() < 0.5, (rays, near)
    for k in FIELDS:
        assert_match(states[1][k], states[0][k], near, k)
    same, none = logs[0].near(logs[0], 0, W, H)
    assert none == 0 and not same.any()
    # one connection verdict flipped (measured: the routes differ on no
    # ray here): its lane's pixel and 3x3 footprint are marked
    flipped = copy.copy(logs[0])
    flipped.casts = list(logs[0].casts)
    lane = 37
    flipped.casts[6] = flipped.casts[6].copy()
    flipped.casts[6][5 * W * H + lane] ^= True
    near, rays = logs[0].near(flipped, 0, W, H)
    y, x = divmod(int(logs[0].pixels[0][lane]), W)
    assert rays == 1 and near[y, x]
    assert near[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].all()
    assert near.sum() <= 9 + 6              # the footprint, its splats
