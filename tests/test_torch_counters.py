"""The program's counters (clive2_tpu_torch/utils/profiling.py:count) on
the CPU.

* With no profiler nothing is counted: a value's function is not called,
  no tensor is made and ``counts`` reads nothing.
* Under a profiler, ``trace.vertices`` and ``trace.specular_vertices``
  equal a plain count of the stored vertices that ``trace_subpaths``
  returns (its ``valid``) and of those among them whose material's type is
  above 0: none on the all-diffuse Cornell room, some on a glass
  (material 5) icosphere.  ``counts`` clears what it reads.
"""

import numpy as np
import pytest
import torch
from torch.profiler import profile

import clive2_tpu_torch as ct
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.integrator import render
from clive2_tpu_torch.models.primitives import icosphere
from clive2_tpu_torch.utils import profiling

torch.set_num_threads(2)

W, H = 16, 12
GLASS = 5                     # default_materials' slot 5: BLUE glass


def _cornell():
    return ct.create_scene_from_preset("empty", W, H, device="cpu")


def _glass_ball():
    """An icosphere of 80 glass triangles in the Cornell room, where the
    camera looks."""
    v, f = icosphere(1)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.5 + np.array([0.0, 1.0, 0.0])).astype(np.float32),
        material=GLASS)
    return ct.create_scene(pixel_width=W, pixel_height=H,
                           cam_center=np.array([0, 1.5, 6]),
                           cam_direction=np.array([0, 0, -1.0]),
                           extra_geometry=soup, device="cpu")


SCENES = dict(cornell=_cornell, glass=_glass_ball)


def _plain_counts(path, mat_type):
    """The stored vertices and those on a specular material, counted in
    numpy from ``trace_subpaths``'s result."""
    valid = path["valid"].numpy()
    types = mat_type.numpy()[path["vertices"]["material"].numpy()]
    return {"trace.vertices": int(valid.sum()),
            "trace.specular_vertices": int((valid & (types > 0)).sum())}


def _traced_paths(monkeypatch):
    """Keeps each result of the renderer's ``trace_subpaths``."""
    paths = []

    def keep(*a, _fn=render.trace_subpaths, **k):
        paths.append(_fn(*a, **k))
        return paths[-1]

    monkeypatch.setattr(render, "trace_subpaths", keep)
    return paths


def test_no_profiler_counts_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    made = []
    monkeypatch.setattr(profiling, "_COUNTS", {})

    def value():
        made.append(1)
        return torch.ones((), dtype=torch.int64)

    profiling.count("trace.vertices", value)
    profiling.count("trace.vertices", torch.ones((), dtype=torch.int64))
    assert made == [] and profiling._COUNTS == {}
    r = ct.Renderer(_cornell(), seed=2)
    r.run_sample()
    assert profiling._COUNTS == {}
    assert profiling.counts() == {}


def test_counts_add_and_clear(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    with profile():
        profiling.count("a", torch.tensor(3))
        profiling.count("a", lambda: torch.tensor(4))
        profiling.count("b", torch.tensor(True))
    assert profiling.counts() == {"a": 7, "b": 1}
    assert profiling.counts() == {}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_counters_equal_a_plain_count(monkeypatch, name):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    scene = SCENES[name]()
    r = ct.Renderer(scene, seed=9)
    r.run_sample()
    paths = _traced_paths(monkeypatch)
    with profile():
        r.run_sample()
        r.run_sample()
    got = profiling.counts()
    assert len(paths) == 2
    want = {}
    for p in paths:
        for k, v in _plain_counts(p, scene.data["mat"]["type"]).items():
            want[k] = want.get(k, 0) + v
    assert got == want
    assert got["trace.vertices"] > 0
    if name == "cornell":
        assert got["trace.specular_vertices"] == 0
    else:
        assert got["trace.specular_vertices"] > 0
