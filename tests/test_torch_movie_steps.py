"""The port's movie as an object (``clive2_tpu_torch/apps/movie.py:Movie``)
on the CPU, at tiny sizes.

* ``Movie`` driven one ``step()`` at a time writes the same PNG bytes as
  the CLI's ``main()``, frame for frame;
* under a profiler every frame boundary is one ``clive2.frame`` span
  holding one ``clive2.frame.image``, ``clive2.frame.save`` and
  ``clive2.frame.camera`` in that order, between two samples; with no
  profiler, no span;
* a frame's PNG is ``tone_map`` of its renderer's accumulators, written
  at zlib's fastest level (upstream's ``cv2.imwrite`` default);
* the previous frame's renderer is freed before the next one is built;
* after its last frame a movie starts its range again, strided or not;
  a movie of no sample a frame is refused.
"""

import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch
from PIL import Image

from clive2_tpu_torch import renderer as renderer_mod
from clive2_tpu_torch.apps import movie
from clive2_tpu_torch.camera import tone_map
from clive2_tpu_torch.utils import profiling

torch.set_num_threads(2)

W, H = 16, 12
EPS = 1e-3                    # µs: the Chrome trace's rounding of ts + dur


def _movie(out, frames=3, samples=2, **kw):
    return movie.Movie("empty", W, H, frames, samples, seed=5,
                       out_dir=str(out), device="cpu", **kw)


def _run(m, steps):
    for _ in range(steps):
        m.step()


def test_steps_write_the_cli_frames(tmp_path):
    movie.main(["--device", "cpu", "--scene", "empty", "--width", str(W),
                "--height", str(H), "--samples", "2", "--movie-frames", "3",
                "--seed", "5", "--output-dir", str(tmp_path),
                "--movie-name", "cli", "--display", "off"])
    m = _movie(tmp_path / "steps")
    _run(m, 6)
    assert m.renderer.samples == 2 and m.frame == 2
    m.end_frame()
    assert [os.path.basename(p) for p in m.frames_written] == [
        f"frame_{f:04d}.png" for f in range(3)]
    for p in m.frames_written:
        with open(p, "rb") as a, open(tmp_path / "cli" / os.path.basename(p),
                                      "rb") as b:
            assert a.read() == b.read()


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(
        e["dur"])) for e in events if e.get("ph") == "X"
        and e.get("cat") == "user_annotation"
        and e["name"].startswith(profiling.SPAN_PREFIX)),
        key=lambda r: r[1])


def test_a_frame_span_a_boundary(tmp_path):
    m = _movie(tmp_path / "m")
    with profiling.trace_to(str(tmp_path)):
        _run(m, 5)                              # two boundaries
    got = _ranges(tmp_path / profiling.TRACE_FILE)
    frames = [r for r in got if r[0] == "clive2.frame"]
    assert len(frames) == 2
    samples = [r for r in got if r[0] == "clive2.sample"]
    assert len(samples) == 5
    for fr in frames:
        inner = [r for r in got if r[0].startswith("clive2.frame.")
                 and fr[1] - EPS <= r[1] and r[2] <= fr[2] + EPS]
        assert [r[0] for r in inner] == ["clive2.frame.image",
                                         "clive2.frame.save",
                                         "clive2.frame.camera"]
        assert not any(fr[1] < s[1] < fr[2] for s in samples)
    assert len([r for r in got if r[0].startswith("clive2.frame.")]) == 6
    # with no profiler running, a boundary opens no range
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("frame") is profiling.span("frame.save")
    m.step()
    assert m.frame == 2 and len(m.frames_written) == 2


def test_the_png_is_the_tone_mapped_accumulators(tmp_path):
    m = _movie(tmp_path, frames=2, samples=3)
    _run(m, 3)
    r = m.renderer
    img = r.state["summed_image"].numpy()
    w = r.state["summed_weight"].numpy()[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = np.nan_to_num(img / w, posinf=0, neginf=0)
    expected = tone_map(raw, exposure=4.0)[:, :, ::-1]   # BGR, saved as RGB
    path = m.end_frame()
    assert m.renderer is None
    got = np.asarray(Image.open(path))
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, expected)
    with open(path, "rb") as f:
        png = f.read()
    idat = png.index(b"IDAT") + 4
    assert png[idat] & 0x0F == 8               # deflate
    assert png[idat + 1] >> 6 == 0             # FLEVEL 0: the fastest


def test_the_old_renderer_is_freed_before_the_next(tmp_path, monkeypatch):
    built = []
    alive_at_build = []
    orig = renderer_mod.Renderer

    def build(*a, **k):
        alive_at_build.append([w() is not None for w in built])
        r = orig(*a, **k)
        built.append(weakref.ref(r))
        return r

    monkeypatch.setattr(renderer_mod, "Renderer", build)
    was = gc.isenabled()
    gc.disable()                 # freed by its count, not by the collector
    try:
        m = _movie(tmp_path, frames=3, samples=1)
        _run(m, 3)
    finally:
        if was:
            gc.enable()
    assert len(built) == 3
    assert alive_at_build == [[], [False], [False, False]]
    assert built[-1]() is m.renderer


def test_a_movie_starts_its_range_again(tmp_path):
    m = _movie(tmp_path, frames=2, samples=1)
    seen = []
    for _ in range(5):
        m.step()
        seen.append((m.frame, m.renderer.key.tolist()))
    assert [f for f, _ in seen] == [0, 1, 0, 1, 0]
    assert seen[0][1] == seen[2][1] != seen[1][1]     # seed + f
    assert len(m.frames_written) == 4
    strided = _movie(tmp_path / "strided", frames=4, samples=1,
                     frame_stride=2, frame_offset=1)
    _run(strided, 3)
    assert strided.frame == 1
    assert strided.frames_written == [
        os.path.join(str(tmp_path / "strided"), f"frame_{f:04d}.png")
        for f in (1, 3)]
    with pytest.raises(ValueError):
        _movie(tmp_path / "none", samples=0)
