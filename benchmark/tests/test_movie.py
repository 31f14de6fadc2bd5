"""The ``movie`` mode (``modes/movie.py``) and its pieces, on the CPU at a
few pixels: a small ``dragon.720p.movie`` cell through the harness (one
sample a frame), its glass dragon replaced by the 3,000-triangle glass
blob in Morton order so that the moved camera's rows land in a BVH
scene's ``camtri`` table, crosses frame boundaries and is ``correct``,
traced or not; the reference's frozen orbit is the
program's for every frame of the movie; planted faults fail the check (a
frame rendered from the previous frame's camera, or with its seed, and
a frame left unwritten); ``frame_idle_ms_per_sample`` on hand-made
records; and, on the card (skipped without one), the dragon movie at
96x54."""

import os

import numpy as np
import pytest

import clive2_tpu_torch.renderer as renderer_mod
import clive2_tpu_torch.scene as scene_mod
from benchmark import manifest, run
from benchmark.reference.orbit import orbit_camera as ref_orbit_camera
from clive2_tpu_torch.apps import movie as movie_mod
from clive2_tpu_torch.integrator import render as render_mod
from clive2_tpu_torch.utils import profiling

from .helpers import BLOB, args, small_cell

CELL = "dragon.720p.movie"
GLASS_BLOB = dict(BLOB, file="glass_blob.ply", material=5)


def _cell(**traffic):
    c = small_cell(CELL, width=32, height=18, **traffic)
    c["config"] = dict(c["config"], scene=dict(c["config"]["scene"],
                                               meshes=[GLASS_BLOB]))
    return c


def _work_in(tmp_path, monkeypatch):
    """The harness's work folder (the frames, the trace) in ``tmp_path``."""
    monkeypatch.setattr(run, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(run, "TRACE_FILE", str(tmp_path / "work" /
                                               "trace.json"))


@pytest.fixture
def blob_movie(tmp_path, monkeypatch):
    """The dragon preset reading the glass blob the harness writes, in
    Morton order as on the card (the CPU's scene has no traversal table,
    and the harness clears the knob), the movie's frames in ``tmp_path``,
    and a list of the frames ended with their scenes."""
    monkeypatch.setattr(render_mod, "_wave_order",
                        lambda scene, mesh=None: "morton")
    spec = scene_mod.scene_presets["dragon"]["file_specs"][0]
    monkeypatch.setitem(spec, "file_path",
                        os.path.join(str(tmp_path), GLASS_BLOB["file"]))
    _work_in(tmp_path, monkeypatch)
    ended = []
    orig = movie_mod.Movie.end_frame

    def end_frame(self):
        ended.append((self.frame, self.renderer.scene))
        return orig(self)

    monkeypatch.setattr(movie_mod.Movie, "end_frame", end_frame)
    yield ended
    profiling.counts()      # the traced run's counters, on this run's device


def _run(tmp_path, seconds=1.5, trace=0, **traffic):
    traffic = dict(dict(samples_per_frame=1, warmup_samples=1,
                        trace_samples=1), **traffic)
    return run.run(_cell(**traffic), args(CELL, seconds=seconds,
                                          trace=trace),
                   device="cpu", resources=str(tmp_path))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_movie_crosses_frames_and_is_correct(tmp_path, blob_movie,
                                                     trace):
    r = _run(tmp_path, trace=trace)
    assert r["correct"] is True, r["check"]
    assert r["check"]["frames_unwritten"]["value"] == 0
    assert r["check"]["off_share"]["value"] <= r["check"]["off_share"][
        "limit"]
    assert len(blob_movie) >= 2                  # frame 0, then a moved one
    assert [f for f, _ in blob_movie[:3]] == list(range(len(
        blob_movie[:3])))
    scene = blob_movie[1][1]
    assert "camtri" in scene.data and "brute" not in scene.data
    assert r["attempted"] >= 1
    assert not os.path.exists(tmp_path / "work" / "movie")


def test_the_reference_orbit_is_the_programs():
    for f in range(120):
        a = scene_mod.orbit_camera(f, 120, 1280, 720).to_pytree()
        b = ref_orbit_camera(f, 120, 1280, 720).to_pytree()
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (f, k)


def _previous_camera(monkeypatch):
    orig = scene_mod.orbit_camera
    monkeypatch.setattr(scene_mod, "orbit_camera",
                        lambda f, n, w, h: orig(f - 1, n, w, h))


def _previous_seed(monkeypatch):
    orig = renderer_mod.Renderer
    monkeypatch.setattr(renderer_mod, "Renderer",
                        lambda scene, seed=0, **k: orig(scene, seed - 1, **k))


def _unwritten(monkeypatch):
    orig = movie_mod.save_png
    monkeypatch.setattr(movie_mod, "save_png", lambda path, image: (
        None if path.endswith("frame_0001.png") else orig(path, image)))


@pytest.mark.parametrize("fault", [_previous_camera, _previous_seed,
                                   _unwritten])
def test_faults_fail_the_check(fault, tmp_path, blob_movie, monkeypatch):
    fault(monkeypatch)
    r = _run(tmp_path, seconds=2.0)
    assert r["correct"] is False
    key = "frames_unwritten" if fault is _unwritten else "off_share"
    assert r["check"][key]["value"] > r["check"][key]["limit"]
    if fault is _unwritten:
        assert r["check"]["frames_unwritten"]["value"] == 1


def test_frame_idle_reader():
    read = manifest.load_metric("frame_idle_ms_per_sample").read
    assert read({}) is None
    assert read(dict(window=dict(seconds=1.0, samples=3))) is None
    gaps = [["clive2.frame.save", 0.05], ["clive2.sample", 0.5],
            ["clive2.frame.image", 0.025], ["clive2.frame", 0.01],
            ["clive2.frames", 9.0], ["host idle", 1.0]]
    t = dict(samples=15, idle_gaps=gaps)
    assert read(dict(trace=t)) == pytest.approx(1e3 * 0.085 / 15)
    assert read(dict(trace=dict(t, idle_gaps=gaps[1:2]))) is None
    assert read(dict(trace=dict(t, samples=0))) is None


@pytest.mark.cuda
def test_small_dragon_movie_on_the_card(card, tmp_path, monkeypatch):
    spec = scene_mod.scene_presets["dragon"]["file_specs"][0]
    monkeypatch.setitem(spec, "file_path", os.path.join(
        str(tmp_path), os.path.basename(spec["file_path"])))
    _work_in(tmp_path, monkeypatch)
    c = small_cell(CELL, width=96, height=54, samples_per_frame=3,
                   trace_samples=3)
    for trace in (0, 1):
        r = run.run(c, args(CELL, seconds=2.0, trace=trace),
                    device=str(card), resources=str(tmp_path))
        assert r["correct"] is True, r["check"]
        assert r["check"]["frames_unwritten"]["value"] == 0
        assert r["device"]["platform"] == "gpu"
    assert r["metrics"]["frame_idle_ms_per_sample"]["value"] > 0
