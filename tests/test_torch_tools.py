"""The port's tools that drive the renderer (clive2_tpu_torch/scripts/)
against the JAX package's scripts/ on the CPU.

* make_assets: the five meshes byte for byte as scripts/make_assets.py
  writes them, and ``testing.write_assets`` writes what is missing with it;
* compare_images: the script's output and exit code on PNG and .npz pairs;
* parity_render: ``--report`` gives the script's record on the committed
  arrays; a small render writes finite images under its output folder;
* smoke_render: exits 0, writes both PNGs, and renders what a ``Renderer``
  renders;
* profile_stages: its stages cast as many rays as the script's;
* movie_launcher: two workers render disjoint frames that make the movie.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu_torch import constants, rng, testing
from clive2_tpu_torch.scene import scene_presets
from clive2_tpu_torch.scripts import (compare_images, make_assets,
                                      parity_render, profile_stages,
                                      smoke_render)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _run(args, cwd=ROOT, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=300)


def _jax_script(name):
    """scripts/<name>.py of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- make_assets --------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The five meshes written by the port's tool and by the script, each
    into its own CLIVE2_RESOURCES."""
    out = {}
    for side, args in (
            ("port", ["-m", "clive2_tpu_torch.scripts.make_assets"]),
            ("jax", [os.path.join("scripts", "make_assets.py")])):
        d = str(tmp_path_factory.mktemp(side))
        p = _run(args, CLIVE2_RESOURCES=d)
        assert p.returncode == 0, p.stderr
        out[side] = (d, p.stdout)
    return out


def test_make_assets_writes_the_scripts_bytes(assets):
    (port, port_out), (jax_, jax_out) = assets["port"], assets["jax"]
    names = [name for name, _ in make_assets.MESHES]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_)) == \
        sorted(names)
    for name in names:
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_, name), "rb") as b:
            assert a.read() == b.read(), name
    assert port_out == jax_out
    assert "dragon_vrip.ply: 871422 tris" in port_out


def test_write_assets_writes_the_missing_meshes(assets, tmp_path):
    """Only what is missing is written (here the big dragon), by the same
    generator."""
    names = [name for name, _ in make_assets.MESHES]
    for name in names:
        if name != "dragon_vrip.ply":
            (tmp_path / name).write_bytes(b"")
    written = testing.write_assets(str(tmp_path))
    assert [k for k, v in written.items() if v is not None] == \
        ["dragon_vrip.ply"]
    want = os.path.join(assets["port"][0], "dragon_vrip.ply")
    with open(want, "rb") as f:
        assert (tmp_path / "dragon_vrip.ply").read_bytes() == f.read()


# ---- compare_images -----------------------------------------------------

def _write_pair(tmp_path, kind, case):
    gen = np.random.default_rng(5)
    if kind == "png":
        a = gen.integers(0, 256, (12, 10, 3), dtype=np.uint8)
        b = a.copy()
        if case == "differ":
            b[3, 4, 1] ^= 0x40
        elif case == "shape":
            b = b[:, :9]
        paths = [str(tmp_path / f"{n}.png") for n in "ab"]
        for x, path in zip((a, b), paths):
            Image.fromarray(x).save(path)
        return paths
    img = gen.uniform(0, 2, (12, 10, 3)).astype(np.float32)
    wgt = gen.uniform(0.5, 3, (12, 10)).astype(np.float32)
    other = dict(same=img, differ=img * 1.01, shape=img[:, :9])[case]
    other_w = wgt[:, :9] if case == "shape" else wgt
    paths = [str(tmp_path / f"{n}.npz") for n in "ab"]
    np.savez(paths[0], summed_image=img, summed_weight=wgt)
    np.savez(paths[1], summed_image=other, summed_weight=other_w)
    return paths


@pytest.mark.parametrize("kind", ["png", "npz"])
@pytest.mark.parametrize("case", ["same", "differ", "shape"])
def test_compare_images_matches_the_script(tmp_path, capsys, kind, case):
    paths = _write_pair(tmp_path, kind, case)
    want = _run([os.path.join("scripts", "compare_images.py"), *paths])
    rc = compare_images.main(paths)
    assert (capsys.readouterr().out, rc) == (want.stdout, want.returncode)
    assert rc == dict(same=0, differ=1, shape=2)[case]


# ---- parity_render ------------------------------------------------------

def test_parity_report_matches_the_script(capsys):
    """On the committed TPU arrays as the port's images: the script's
    record, and each estimator equal to itself."""
    want = _run([os.path.join("scripts", "parity_render.py"), "--report"])
    assert want.returncode == 0, want.stderr
    tpu = parity_render.TPU_IMAGES
    rec, vs = parity_render.report(out=tpu, tpu=tpu)
    assert rec == json.loads(want.stdout)
    printed = capsys.readouterr().out
    assert printed.startswith(want.stdout)
    assert json.loads(printed[len(want.stdout):]) == vs
    for tag in parity_render.ESTIMATORS:
        assert vs[tag]["mean_ratio_bgr"] == [1.0, 1.0, 1.0]
        assert vs[tag]["rmse_tonemapped"] == 0.0


@pytest.fixture
def small_teapots(tmp_path, monkeypatch):
    """The teapots preset on a teapot.obj in ``tmp_path``, and the parity
    workload cut to 24x16 and 2 samples, written under ``tmp_path``."""
    make_assets.write_mesh(str(tmp_path), "teapot.obj")
    preset = dict(scene_presets["teapots"])
    preset["file_specs"] = [
        dict(spec, file_path=str(tmp_path / "teapot.obj"))
        for spec in preset["file_specs"]]
    monkeypatch.setitem(scene_presets, "teapots", preset)
    out = tmp_path / "output" / "parity"
    for name, value in (("W", 24), ("H", 16), ("SPP", 2),
                        ("OUT", str(out))):
        monkeypatch.setattr(parity_render, name, value)
    return out


def test_parity_render_writes_finite_images(small_teapots, monkeypatch):
    raws = {}
    for tag, reference in (("production", False), ("refmis", True)):
        monkeypatch.setattr(constants, "REFERENCE_MIS", reference)
        raws[tag] = parity_render.render("cpu")
        saved = np.load(small_teapots / f"parity_{tag}_raw.npy")
        np.testing.assert_array_equal(saved, raws[tag])
        assert saved.shape == (16, 24, 3)
        assert np.isfinite(saved).all() and saved.mean() > 0
        png = np.asarray(Image.open(small_teapots / f"parity_{tag}.png"))
        assert png.shape == (16, 24, 3)
    assert not np.array_equal(raws["production"], raws["refmis"])


# ---- smoke_render -------------------------------------------------------

def test_smoke_render_cli_exits_0_and_writes_both_pngs(tmp_path):
    p = _run(["-m", "clive2_tpu_torch.scripts.smoke_render", "--cpu",
              "--size=32", "--spp=2"], cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr
    for name in ("smoke_bdpt.png", "smoke_uni.png"):
        assert np.asarray(Image.open(tmp_path / "output" / name)).shape == \
            (32, 32, 3)
    lines = p.stdout.splitlines()
    assert lines[0].startswith("scene: 16 tris")
    assert any(ln.startswith("raw image stats:") for ln in lines)


def test_smoke_render_renders_what_a_renderer_renders(tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = smoke_render.main(["--cpu", "--size=32", "--spp=2"])
    r = ct.Renderer(ct.create_scene_from_preset("empty", 32, 32,
                                                device="cpu"), seed=7)
    for _ in range(2):
        r.run_sample()
    np.testing.assert_array_equal(got.raw_image, r.raw_image)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "output" / "smoke_bdpt.png")),
        r.image[:, :, ::-1])


# ---- profile_stages -----------------------------------------------------

def test_profile_stages_casts_the_scripts_rays():
    """Cornell ``empty`` 16x16, key 0: the subpath trace's rays, the active
    connection rays and the sample's rays equal those of the script's
    ``subpaths``, ``casts_only`` and ``render_sample`` (JAX on the CPU)."""
    script = _jax_script("profile_stages")
    w = h = 16
    js = c2.create_scene_from_preset("empty", pixel_width=w, pixel_height=h)
    key = jax.random.key(0)
    cam_path, light_path = script.subpaths(key, js.data, w, h)
    casts = script.casts_only(cam_path, light_path, js.data, w, h)
    want = dict(path=int(cam_path["n_rays"]),
                casts=int(np.asarray(casts[2]).sum()),
                sample=int(script.render_sample(key, js.data, w,
                                                h)["n_rays"]))

    ts = ct.create_scene_from_preset("empty", w, h, device="cpu")
    f = profile_stages.stages(ts.data, w, h, "raster")
    k = rng.key(0)
    got = dict(path=int(f["trace"](k)["n_rays"]),
               casts=int(f["casts"](k)[2].sum()),
               sample=int(f["full"](k)["n_rays"]))
    assert got == want
    assert got["sample"] == got["path"] + got["casts"]


# ---- movie_launcher -----------------------------------------------------

def test_movie_launcher_shards_the_frames(tmp_path):
    out = tmp_path / "movies"
    stale = out / "m" / "frame_0009.png"
    stale.parent.mkdir(parents=True)
    stale.write_bytes(b"")
    p = _run(["-m", "clive2_tpu_torch.scripts.movie_launcher", "--workers",
              "2", "--", "--device", "cpu", "--scene", "empty", "--width",
              "16", "--height", "12", "--samples", "1", "--movie-frames",
              "4", "--movie-name", "m", "--output-dir", str(out)])
    assert p.returncode == 0, p.stderr
    launches = [ln for ln in p.stdout.splitlines()
                if ln.startswith("launch:")]
    assert [ln.split("--frame-offset ")[1].split()[0] for ln in launches] \
        == ["0", "1"]
    rendered = sorted(int(ln.split()[1]) for ln in p.stdout.splitlines()
                      if ln.startswith("Frame "))
    assert rendered == [0, 1, 2, 3]          # each frame by one worker
    assert sorted(os.listdir(out / "m")) == [
        f"frame_{i:04d}.png" for i in range(4)]
