"""The big-dragon preset (871,422 mesh triangles) end to end against the
JAX package on the CPU.

The mesh is the port's ``scripts/make_assets.py`` stand-in
(``dragon_vrip.ply``, written into a temporary directory); both packages
build the preset's scene from it at 16x16.  The port takes its ``stream2``
table (the scene is past ``STREAM2_MIN_TRIS``), so ``stream2_plain``
carries every cast of the sample; the JAX package renders with its gather
walk, since it packs stream2 only on a TPU.  Both in raster order (the
JAX package's order on the CPU).  One sample, seed 77.

The fat-leaf test reorders the Möller-Trumbore arithmetic, so its near
ties differ from the gather walk's: measured 19 differing rays over the
sample's 7 casts (12,288 rays), reaching 43% of the pixels.  On this dense
mesh with smooth normals the reordered arithmetic also travels along a
path whose ids agree: measured t differs from the JAX package's by up to
8e-4 relative at depth 1 and 5% at depth 5, so a lane's contribution can
move by 1e-3 without a near tie in ids.  Outside near-tie pixels the
measured sample matches at the golden tolerance on 869 of its 876 image,
weight, squared-luma and count values (the 7 others, around one lane's
pixel, are off by up to 2.1e-3 relative), and the unidirectional image on
every pixel.  The bounds below are about 3x the
measured figures, the share of pixels 0.6 (the share cannot grow 3x).
"""

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu_torch.ops import intersect, traverse_stream2
from clive2_tpu_torch.scene import scene_presets
from clive2_tpu_torch.scripts.make_assets import write_mesh
from test_torch_slice import FIELDS, SEED
from torch_parity import ATOL, RTOL, NearTies, assert_match, check_ties

torch.set_num_threads(2)

W = H = 16
MESH = "dragon_vrip.ply"
MAX_DIFFERING_RAYS = 60       # measured 19
NEAR_TIE_MAX = 0.6            # measured 0.43
GOLDEN_SHARE = 0.98           # of the values outside near ties; measured
                              # 869 / 876 = 0.992
RTOL_ALL = 5e-3               # every value outside near ties; measured
                              # 2.1e-3


def _scene(pkg, path, **kw):
    preset = scene_presets["big-dragon"]
    return pkg.create_scene(
        pixel_width=W, pixel_height=H, cam_center=preset["cam_center"],
        cam_direction=preset["cam_direction"],
        file_specs=[dict(spec, file_path=path)
                    for spec in preset["file_specs"]], **kw)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("resources"))
    tris = write_mesh(d, MESH)
    path = f"{d}/{MESH}"
    ts = _scene(ct, path, device="cpu")
    js = _scene(c2, path)
    assert "stream2" in ts.data and "bvh2" not in ts.data
    jax_renderer._make_step.cache_clear()    # trace anew, with recording
    jax.clear_caches()
    jr = c2.Renderer(js, seed=SEED)
    tr = ct.Renderer(ts, seed=SEED)
    calls = traverse_stream2.stream2_plain.calls
    walks = intersect.intersect_bvh_packed.calls
    with NearTies() as ties, pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIVE2_WAVE_ORDER", "raster")
        jr.run_sample()
        tr.run_sample()
    return dict(
        mesh_tris=tris, scene_tris=(ts.n_triangles, js.n_triangles),
        ties=ties,
        plain_calls=traverse_stream2.stream2_plain.calls - calls,
        walk_calls=intersect.intersect_bvh_packed.calls - walks,
        want={k: np.asarray(jr.state[k]) for k in FIELDS},
        got={k: tr.state[k].numpy() for k in FIELDS})


def test_big_dragon_scene_is_the_871k_mesh(sample):
    assert sample["mesh_tris"] == 871_422
    port, jax_ = sample["scene_tris"]
    assert port == jax_ > sample["mesh_tris"]


def test_stream2_carries_every_big_dragon_cast(sample):
    assert sample["plain_calls"] == 7          # 6 extension + 1 connection
    assert sample["walk_calls"] == 0


def test_big_dragon_sample_matches_jax(sample):
    near = check_ties(sample["ties"], W, H, samples=[0],
                      max_rays=MAX_DIFFERING_RAYS, max_share=NEAR_TIE_MAX)
    assert_match(sample["got"]["summed_unidirectional"],
                 sample["want"]["summed_unidirectional"],
                 np.zeros_like(near), "summed_unidirectional")
    golden = total = 0
    for k in FIELDS:
        if k == "summed_unidirectional":
            continue
        got, want = sample["got"][k], sample["want"][k]
        far = np.broadcast_to(~near.reshape(near.shape + (1,) * (
            want.ndim - 2)), want.shape)
        np.testing.assert_allclose(got[far], want[far], rtol=RTOL_ALL,
                                   atol=ATOL, err_msg=k)
        golden += int(np.isclose(got[far], want[far], rtol=RTOL,
                                 atol=ATOL).sum())
        total += int(far.sum())
    assert golden >= GOLDEN_SHARE * total, (golden, total)
    assert sample["got"]["summed_image"].mean() > 0
