"""The port's CLIs on the CPU (``--device cpu``), at tiny sizes.

The JAX package's CLI tests (tests/test_apps.py), ported, and each PNG held
bit for bit to a ``Renderer`` driven by hand with the same scene, seed and
sample count: the render CLI's image and unidirectional image and its
resume, the movie's frames (orbit frames after the first through
``with_camera``, seed + frame), and frame sharding over two processes'
worth of offsets.  ``--aot-cache`` is accepted, and ``--device cuda``
without a card raises.
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

import clive2_tpu_torch as ct
from clive2_tpu_torch.apps import movie, render

torch.set_num_threads(2)


def _png(path):
    return np.asarray(Image.open(path))


def _rgb(renderer_image):
    return renderer_image[:, :, ::-1]          # the CLIs write BGR as RGB


def test_render_cli(tmp_path):
    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck.npz")
    args = ["--device", "cpu", "--scene", "empty", "--width", "24",
            "--height", "16", "--output-dir", out, "--checkpoint", ck,
            "--aot-cache", "x"]
    render.main(args + ["--samples", "2", "--unidirectional"])
    pngs = sorted(glob.glob(os.path.join(out, "*.png")))
    assert len(pngs) == 2                      # main + unidirectional
    assert os.path.exists(ck)
    r = ct.Renderer(ct.create_scene_from_preset("empty", 24, 16,
                                                device="cpu"), seed=0)
    r.run_sample()
    r.run_sample()
    main = [p for p in pngs if not p.endswith("_unidirectional.png")][0]
    np.testing.assert_array_equal(_png(main), _rgb(r.image))
    np.testing.assert_array_equal(_png(main[:-4] + "_unidirectional.png"),
                                  _rgb(r.unidirectional_image))

    # resume: continues from sample 2
    for p in pngs:
        os.remove(p)
    render.main(args + ["--samples", "3"])
    assert int(np.load(ck)["samples"]) == 3
    r.run_sample()
    (png,) = glob.glob(os.path.join(out, "*.png"))
    np.testing.assert_array_equal(_png(png), _rgb(r.image))


def _frames(out, name):
    return sorted(glob.glob(os.path.join(out, name, "*.png")))


def test_movie_cli(tmp_path):
    out = str(tmp_path)
    movie.main(["--device", "cpu", "--scene", "empty", "--width", "24",
                "--height", "16", "--samples", "1", "--movie-frames", "3",
                "--movie-name", "m", "--output-dir", out, "--seed", "5",
                "--aot-cache", ""])
    frames = _frames(out, "m")
    assert [os.path.basename(f) for f in frames] == [
        f"frame_{i:04d}.png" for i in range(3)]
    a, b = _png(frames[0]), _png(frames[1])
    assert not np.array_equal(a, b)            # the camera orbits
    base = ct.create_scene_from_preset_with_params("empty", 24, 16, 0, 3,
                                                   device="cpu")
    for f in range(3):
        scene = base if f == 0 else base.with_camera(
            ct.orbit_camera(f, 3, 24, 16))
        r = ct.Renderer(scene, seed=5 + f)
        r.run_sample()
        np.testing.assert_array_equal(_png(frames[f]), _rgb(r.image))


def test_movie_frame_sharding(tmp_path):
    """Two offsets of stride 2 give every frame, each bit-equal to the
    unsharded run's (offset 1 builds its base scene at frame 1)."""
    common = ["--device", "cpu", "--scene", "empty", "--width", "16",
              "--height", "16", "--samples", "1", "--movie-frames", "4",
              "--output-dir", str(tmp_path)]
    movie.main(common + ["--movie-name", "whole"])
    for offset in (0, 1):
        movie.main(common + ["--movie-name", "s", "--frame-stride", "2",
                             "--frame-offset", str(offset)])
    sharded, whole = _frames(tmp_path, "s"), _frames(tmp_path, "whole")
    assert [os.path.basename(f) for f in sharded] == [
        f"frame_{i:04d}.png" for i in range(4)]
    for a, b in zip(sharded, whole):
        np.testing.assert_array_equal(_png(a), _png(b))


@pytest.mark.parametrize("main", [render.main, movie.main])
def test_cli_on_cuda_without_a_card_raises(tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--scene", "empty", "--width", "8", "--height", "8",
              "--samples", "1", "--output-dir", str(tmp_path)])
