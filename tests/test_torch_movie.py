"""Camera moves against the JAX package on the CPU: ``orbit_camera``,
``create_scene_from_preset_with_params`` and ``Scene.with_camera``.

* the cameras' fields equal the JAX package's (atol 0);
* ``with_camera`` on a brute scene (Cornell) and on a BVH scene (the
  1,280-triangle displaced blob of tests/test_scene.py) swaps the same rows
  as the JAX package's: every table it changes equals the JAX one, converted
  as ``convert.py`` converts it, at atol 0; the base scene is unchanged, and
  the tables it does not change are the base scene's own tensors;
* a ``with_camera`` frame equals a full rebuild at that camera, port
  against port, at the JAX test's bound (rtol 1e-5, atol 1e-7);
* the port's ``with_camera`` frame against the JAX one (same key, 20x20) at
  the golden tolerance outside near-tie pixels (tests/torch_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu.integrator.render import render_sample_jit
from clive2_tpu.load import soup_from_mesh as jax_soup_from_mesh
from clive2_tpu.models import displaced_blob
from clive2_tpu.scene import orbit_camera as jax_orbit_camera
from clive2_tpu_torch import rng
from clive2_tpu_torch.convert import scene_data_from_jax
from clive2_tpu_torch.integrator.render import render_sample
from clive2_tpu_torch.load import soup_from_mesh as torch_soup_from_mesh
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

CAMERA_FIELDS = ("center", "direction", "phys_width", "phys_height",
                 "pixel_width", "pixel_height", "dx", "dy", "focal_point",
                 "origin")
# the tables with_camera swaps rows in (by scene kind), and those it keeps
SWAPPED = {"brute": ("camera", "brute", "tri"),
           "bvh": ("camera", "camtri", "tri")}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _same_cameras(got, want):
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("frame,total,w,h", [(0, 1, 20, 20), (3, 16, 20, 20),
                                             (7, 120, 32, 18)])
def test_orbit_camera_matches_jax(frame, total, w, h):
    _same_cameras(ct.orbit_camera(frame, total, w, h),
                  jax_orbit_camera(frame, total, w, h))
    got = ct.create_scene_from_preset_with_params("empty", w, h, frame,
                                                  total, device="cpu")
    want = c2.create_scene_from_preset_with_params("empty", w, h, frame,
                                                   total)
    _same_cameras(got.camera, want.camera)
    for k, v in got.data["camera"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(want.data["camera"][k]), k)


def test_with_params_refuses_unknown_preset():
    with pytest.raises(ValueError, match="not found"):
        ct.create_scene_from_preset_with_params("nope", device="cpu")


def _blob(pkg, soup_from_mesh, **kw):
    v, f = displaced_blob(subdivisions=3)              # 1,280 triangles
    blob = soup_from_mesh(v * 20.0, f, material=3,
                          offset=np.array([0, 2.0, 0]))
    return pkg.create_scene(pixel_width=24, pixel_height=24,
                            cam_center=np.array([0, 1.5, 6]),
                            cam_direction=np.array([0, 0, -1]),
                            extra_geometry=blob, **kw)


@pytest.fixture(scope="module", params=["brute", "bvh"])
def moved(request):
    """One scene of each kind in both packages, and each moved to frame 3
    of 16."""
    if request.param == "brute":
        js = c2.create_scene_from_preset("empty", 20, 20)
        ts = ct.create_scene_from_preset("empty", 20, 20, device="cpu")
        cam = (20, 20)
    else:
        js = _blob(c2, jax_soup_from_mesh)
        ts = _blob(ct, torch_soup_from_mesh, device="cpu")
        cam = (24, 24)
    assert ("brute" in ts.data) == (request.param == "brute")
    before = _np(ts.data)
    jm = js.with_camera(jax_orbit_camera(3, 16, *cam))
    tm = ts.with_camera(ct.orbit_camera(3, 16, *cam))
    return dict(kind=request.param, js=js, ts=ts, jm=jm, tm=tm,
                before=before)


def test_with_camera_matches_jax_table_for_table(moved):
    want = _np(scene_data_from_jax(jax.tree.map(np.asarray, moved["jm"].data)))
    got = _np(moved["tm"].data)
    for name in SWAPPED[moved["kind"]]:
        assert got[name].keys() == want[name].keys(), name
        for k in got[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          f"{name}/{k}")
    # the sensor really moved
    assert not np.array_equal(got["camera"]["center"],
                              moved["before"]["camera"]["center"])
    tm, ts = moved["tm"], moved["ts"]
    assert tm.build_seconds == 0.0
    assert (tm.pixel_width, tm.pixel_height) == (ts.pixel_width,
                                                 ts.pixel_height)
    np.testing.assert_array_equal(tm.camera.center,
                                  moved["jm"].camera.center)


def test_with_camera_leaves_the_base_scene_and_shares_the_rest(moved):
    ts, tm = moved["ts"], moved["tm"]
    after = _np(ts.data)
    for name, table in moved["before"].items():
        for k, v in table.items():
            np.testing.assert_array_equal(after[name][k], v, f"{name}/{k}")
    swapped = SWAPPED[moved["kind"]]
    for name in ts.data:
        if name in swapped:
            continue
        for k, v in ts.data[name].items():
            assert tm.data[name][k] is v, f"{name}/{k} was copied"
    kept = set(ts.data["tri"]) - {"face_normal", "n0", "n1", "n2", "packed"}
    for k in kept:
        assert tm.data["tri"][k] is ts.data["tri"][k], k
    if moved["kind"] == "bvh":
        assert "bvh" in tm.data and "brute" not in tm.data


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_with_camera_frame_equals_a_full_rebuild(kind):
    """Port against port: the JAX test's bound (test_scene.py:49-68)."""
    if kind == "brute":
        w = h = 20
        base = ct.create_scene_from_preset("empty", w, h, device="cpu")
        kw = {}
    else:
        w = h = 16
        v, f = displaced_blob(subdivisions=3)
        blob = torch_soup_from_mesh(v * 20.0, f, material=3,
                                    offset=np.array([0, 2.0, 0]))
        base = ct.create_scene(pixel_width=w, pixel_height=h,
                               extra_geometry=blob, device="cpu")
        kw = dict(extra_geometry=blob)
    cam = ct.orbit_camera(3, 16, w, h)
    fast = base.with_camera(cam)
    full = ct.create_scene(pixel_width=w, pixel_height=h,
                           cam_center=cam.center,
                           cam_direction=cam.direction, device="cpu", **kw)
    a = render_sample(rng.key(5), fast.data, w, h)
    b = render_sample(rng.key(5), full.data, w, h)
    for k in ("image", "weight", "unidirectional"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert a["image"].sum() > 0


def test_with_camera_frame_matches_jax():
    w = h = 20
    jfast = c2.create_scene_from_preset("empty", w, h).with_camera(
        jax_orbit_camera(3, 16, w, h))
    tfast = ct.create_scene_from_preset("empty", w, h, device="cpu"
                                        ).with_camera(
        ct.orbit_camera(3, 16, w, h))
    jax.clear_caches()                    # trace anew, with recording
    with NearTies() as ties:
        want = render_sample_jit(jax.random.key(5), jfast.data, w, h)
        want = {k: np.asarray(v) for k, v in want.items()}
        got = render_sample(rng.key(5), tfast.data, w, h)
    near = check_ties(ties, w, h)
    for k in ("image", "weight"):
        assert_match(got[k].numpy(), want[k], near, k)
    assert_match(got["unidirectional"].numpy(), want["unidirectional"],
                 np.zeros_like(near), "unidirectional")
    assert int(got["n_rays"]) > 0
