"""The program's spans (clive2_tpu_torch/utils/profiling.py:span) on the CPU.

* The gate: with no profiler ``span`` hands out one shared null context,
  and it follows the profiler's own state as a profiler starts and stops;
  a sample renders bit for bit the same with a profiler on and off.
* The tree of a sample under ``trace_to``: one ``clive2.sample`` holding
  one ``clive2.trace`` and one ``clive2.connect``, every ``clive2.cast``
  inside one of the two and one a call of ``intersect_scene``, every
  ``clive2.trace.shade`` inside the trace, every ``clive2.rng`` inside the
  sample; on a scene with a streaming table in Morton order, two
  ``clive2.cast.sort`` ranges inside each sorted cast.
* ``clive2.trace.shade`` once a bounce, between its cast and the next.
* ``queued_cast`` waits once a round read: its ``clive2.wait`` ranges
  number its rounds plus its chunks.
"""

import json

import numpy as np
import pytest
import torch

import clive2_tpu_torch as ct
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.constants import MAX_BOUNCES
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.integrator import connect, trace
from clive2_tpu_torch.models.primitives import icosphere
from clive2_tpu_torch.ops import intersect
from clive2_tpu_torch.ops import traverse_stream2 as s2
from clive2_tpu_torch.utils import profiling

torch.set_num_threads(2)

W = H = 16
FIELDS = ("summed_image", "summed_weight", "summed_unidirectional",
          "summed_sq", "pixel_count", "n_samples")
EPS = 1e-3                    # µs: the Chrome trace's rounding of ts + dur


def _ranges(logdir):
    """The ``clive2.*`` ranges of ``trace_to``'s trace in ``logdir``, as
    (name without the prefix, start, end) in µs, by start."""
    with open(logdir / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    n = len(profiling.SPAN_PREFIX)
    return sorted(
        ((e["name"][n:], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
         for e in events if e.get("ph") == "X"
         and e.get("cat") == "user_annotation"
         and e["name"].startswith(profiling.SPAN_PREFIX)),
        key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] - EPS <= inner[1] and inner[2] <= outer[2] + EPS


def _of(ranges, name):
    return [r for r in ranges if r[0] == name]


def _cornell():
    return ct.create_scene_from_preset("empty", W, H, device="cpu")


@pytest.fixture(scope="module")
def ico():
    """An icosphere of 320 triangles on the fat-leaf (``stream2``) tables,
    the streaming route whose casts sort."""
    v, f = icosphere(2)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.5 + np.array([0.0, 1.0, 0.0])).astype(np.float32),
        material=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
        scene = ct.create_scene(pixel_width=W, pixel_height=H,
                                cam_center=np.array([0, 1.5, 6]),
                                cam_direction=np.array([0, 0, -1.0]),
                                extra_geometry=soup, device="cpu")
    assert "stream2" in scene.data
    return scene


def _rays(data, n=600):
    """Rays from inside the scene's root box in every direction, 80%
    active: (origin, direction, active, t_max)."""
    g = torch.Generator().manual_seed(6)
    lo, hi = data["stream2"]["lo"], data["stream2"]["hi"]
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    d = torch.randn(n, 3, generator=g)
    return (o, d / d.norm(dim=1, keepdim=True),
            torch.rand(n, generator=g) < 0.8, torch.full((n,), np.inf))


def _state(r):
    return {k: r.state[k].clone() for k in FIELDS}


def _cast_counter(monkeypatch):
    """Counts the integrator's ``intersect_scene`` calls."""
    calls = []
    for mod in (trace, connect):
        def count(*a, _fn=mod.intersect_scene, **k):
            calls.append(1)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, "intersect_scene", count)
    return calls


def test_no_profiler_no_span():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("sample")
    assert off is profiling.span("cast.sort")
    with off:
        pass
    assert off is profiling.span("wait")


def test_the_gate_follows_the_profiler():
    from torch.profiler import profile

    for _ in range(2):
        assert not torch._C._autograd._profiler_enabled()
        assert profiling.span("rng") is profiling.span("cast")
        with profile() as prof:
            assert torch._C._autograd._profiler_enabled()
            on = profiling.span("rng")
            assert on is not profiling.span("rng")
            assert isinstance(on, torch.profiler.record_function)
            with on:
                torch.ones(4).sum()
        assert not torch._C._autograd._profiler_enabled()
        assert profiling.span("rng") is profiling.span("cast")
        assert [e.key for e in prof.key_averages()].count("clive2.rng") == 1


@pytest.mark.parametrize("method", ["run_sample", "run_adaptive_sample"])
def test_a_sample_is_the_same_traced(tmp_path, method):
    scene = _cornell()
    states = []
    for traced in (False, True):
        r = ct.Renderer(scene, seed=3)
        r.run_sample()
        if traced:
            with profiling.trace_to(str(tmp_path)):
                getattr(r, method)()
            assert _of(_ranges(tmp_path), "sample")
        else:
            getattr(r, method)()
        states.append(_state(r))
    for k in FIELDS:
        assert torch.equal(states[0][k], states[1][k]), k


@pytest.mark.parametrize("method", ["run_sample", "run_adaptive_sample"])
def test_the_span_tree_of_a_sample(tmp_path, monkeypatch, method):
    r = ct.Renderer(_cornell(), seed=5)
    r.run_sample()
    calls = _cast_counter(monkeypatch)
    with profiling.trace_to(str(tmp_path)):
        getattr(r, method)()
    got = _ranges(tmp_path)
    sample, = _of(got, "sample")
    stage, = _of(got, "trace")
    conn, = _of(got, "connect")
    assert _inside(stage, sample) and _inside(conn, sample)
    assert stage[2] <= conn[1] + EPS
    casts = _of(got, "cast")
    assert len(casts) == len(calls) > 1
    assert all(_inside(c, stage) or _inside(c, conn) for c in casts)
    assert any(_inside(c, stage) for c in casts)
    assert any(_inside(c, conn) for c in casts)
    draws = _of(got, "rng")
    assert draws and all(_inside(d, sample) for d in draws)
    assert any(_inside(d, stage) for d in draws)
    shades = _of(got, "trace.shade")
    assert shades and all(_inside(s, stage) for s in shades)
    # the brute casts do not sort, and nothing here queues
    assert {g[0] for g in got} == {"sample", "trace", "trace.shade",
                                   "connect", "cast", "rng"}


def test_a_shade_span_a_bounce(tmp_path):
    """``clive2.trace.shade`` once a bounce, ``MAX_BOUNCES`` times a sample,
    inside ``clive2.trace``, each after its bounce's cast and before the
    next."""
    r = ct.Renderer(_cornell(), seed=4)
    with profiling.trace_to(str(tmp_path)):
        r.run_sample()
    got = _ranges(tmp_path)
    stage, = _of(got, "trace")
    shades = _of(got, "trace.shade")
    casts = [c for c in _of(got, "cast") if _inside(c, stage)]
    assert len(shades) == len(casts) == MAX_BOUNCES
    assert all(_inside(s, stage) for s in shades)
    for k, (cast, shade) in enumerate(zip(casts, shades)):
        assert cast[2] <= shade[1] + EPS
        if k + 1 < len(casts):
            assert shade[2] <= casts[k + 1][1] + EPS


def test_sorted_casts_hold_their_sort_spans(tmp_path, monkeypatch, ico):
    """A scene with a ``stream2`` table renders in Morton order and sorts
    each extension cast, not the connection cast: two ``clive2.cast.sort``
    ranges (sort and gathers, unsort) inside each extension cast."""
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "auto")
    r = ct.Renderer(ico, seed=7)
    calls = _cast_counter(monkeypatch)
    with profiling.trace_to(str(tmp_path)):
        r.run_sample()
    got = _ranges(tmp_path)
    stage, = _of(got, "trace")
    casts = _of(got, "cast")
    assert len(casts) == len(calls)
    sorts = _of(got, "cast.sort")
    sorted_casts = [c for c in casts if any(_inside(s, c) for s in sorts)]
    assert all(_inside(c, stage) for c in sorted_casts)
    assert len(sorted_casts) == sum(_inside(c, stage) for c in casts) > 1
    assert len(sorts) == 2 * len(sorted_casts)
    assert all(any(_inside(s, c) for c in casts) for s in sorts)


@pytest.mark.parametrize("sort", [False, True])
def test_a_cast_sorts_inside_its_span(tmp_path, ico, sort):
    """``intersect_scene`` on a ``stream2`` table: one ``clive2.cast``, and
    inside it two ``clive2.cast.sort`` ranges, one before the traversal and
    one after it, or none unsorted."""
    o, d, active, t_max = _rays(ico.data)
    with profiling.trace_to(str(tmp_path)):
        intersect.intersect_scene(o, d, ico.data, active=active,
                                  t_max=t_max, sort=sort)
    got = _ranges(tmp_path)
    cast, = _of(got, "cast")
    sorts = _of(got, "cast.sort")
    assert len(sorts) == (2 if sort else 0)
    assert all(_inside(s, cast) for s in sorts)
    if sort:
        assert sorts[0][2] <= sorts[1][1]


@pytest.mark.parametrize("chunk,tail_min", [(64, 20), (7, 3), (s2.CHUNK, 0)])
def test_the_queue_waits_once_a_round_read(tmp_path, ico, chunk, tail_min):
    rays = _rays(ico.data)
    n = rays[0].shape[0]

    def cast():
        out = (torch.empty(n, dtype=torch.int32), torch.empty(n),
               torch.empty(n), torch.empty(n))
        steps = s2.PlainSteps(ico.data["stream2"], False)
        return s2.queued_cast(rays, steps, out, chunk=chunk,
                              tail_min=tail_min)[0]

    with profiling.trace_to(str(tmp_path)):
        rounds = cast()
    waits = _of(_ranges(tmp_path), "wait")
    chunks = -(-n // chunk)
    assert len(waits) == rounds + chunks and rounds >= chunks
    assert cast() == rounds             # the same schedule, untraced
