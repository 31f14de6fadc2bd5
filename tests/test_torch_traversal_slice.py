"""The JAX package's two A/B traversal paths end to end on the CPU, selected
by its own environment variables, and the dispatch that reads them.

The icosphere BVH scene of tests/test_torch_slice.py (334 triangles) is
built by the port under ``CLIVE2_TRAVERSAL=wide`` (the ``wide`` table:
``wide_plain`` carries every cast) and under ``CLIVE2_TRAVERSAL=stream``
with ``CLIVE2_STREAM_IMPL=1`` (the ``stream`` table: ``stream_plain``).
The JAX package renders the same scene with its gather walk, since it
packs those tables only on a TPU.  One sample is compared at the golden
tolerance outside near-tie pixels (tests/torch_parity.py), the
unidirectional image on every pixel.  Both walks run the gather walk's
Möller-Trumbore arithmetic, so their near ties are the gather-walk port's.
The any-hit connection cast is compared by verdict, since an any-hit
traversal may report any hit under the cap (by id, the wide walk differs
from the JAX gather walk on 14 of its 9,216 rays and the streaming walk on
1).  Measured: 0 differing rays over the sample's 7 casts (12,288 rays)
on both paths and 0 near-tie pixels, as the gather-walk port measures on
this scene; the bound is 3 rays, and a fault that flips more fails.

Then the dispatch matrix: which table each selector gives a scene of each
size on the CPU and for CUDA, today's tables with neither variable set,
and the same tables for a converted JAX scene.
"""

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.convert import scene_data_from_jax
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from clive2_tpu_torch.geometry import box_geometry, camera_geometry
from clive2_tpu_torch.materials import default_materials
from clive2_tpu_torch.ops import intersect, traverse_stream, traverse_wide
from test_torch_slice import FIELDS, SEED, H, W, _bvh_scene
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

MAX_DIFFERING_RAYS = 3        # measured 0 on both paths
SELECTORS = {
    # name: (environment, table, its plain version)
    "wide": (dict(CLIVE2_TRAVERSAL="wide"), "wide", traverse_wide.wide_plain),
    "stream1": (dict(CLIVE2_TRAVERSAL="stream", CLIVE2_STREAM_IMPL="1"),
                "stream", traverse_stream.stream_plain),
}


def _verdicts(casts):
    """Recorded cast ids, the any-hit connection cast's as verdicts (hit
    or not): there each traversal may report any hit under the cap, and
    only the verdict reaches the image, so it is compared as the kernel
    tests compare any-hit casts.  The extension casts keep their ids."""
    return [c if c.size == 2 * W * H else (c >= 0).astype(np.int32)
            for c in casts]


@pytest.fixture(scope="module")
def samples():
    """One sample of the JAX renderer and, per selector, of the port."""
    js = _bvh_scene(c2, JaxSoup)
    jax_renderer._make_step.cache_clear()    # trace anew, with recording
    jax.clear_caches()
    jr = c2.Renderer(js, seed=SEED)
    out, first = {}, None
    for name, (env, table, plain) in SELECTORS.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            ts = _bvh_scene(ct, TorchSoup, device="cpu")
        tr = ct.Renderer(ts, seed=SEED)
        calls, walks = plain.calls, intersect.intersect_bvh_packed.calls
        # the JAX package's CPU scene has no traversal table and renders in
        # raster order; with one, the port's default order would be morton
        with NearTies() as ties, pytest.MonkeyPatch.context() as mp:
            mp.setenv("CLIVE2_WAVE_ORDER", "raster")
            if first is None:
                jr.run_sample()
            tr.run_sample()
        if first is None:
            first = ties
            ties.jax_casts[:] = _verdicts(ties.jax_casts)
        else:                     # the JAX sample's casts, recorded once
            ties.jax_casts, ties.jax_splats = (first.jax_casts,
                                               first.jax_splats)
        ties.torch_casts[:] = _verdicts(ties.torch_casts)
        out[name] = dict(ties=ties, tables=sorted(ts.data),
                         plain_calls=plain.calls - calls,
                         walk_calls=intersect.intersect_bvh_packed.calls
                         - walks,
                         got={k: tr.state[k].numpy() for k in FIELDS})
    want = {k: np.asarray(jr.state[k]) for k in FIELDS}
    return out, want


@pytest.mark.parametrize("name", list(SELECTORS))
def test_selected_plain_walk_carries_every_cast(samples, name):
    run = samples[0][name]
    table = SELECTORS[name][1]
    assert table in run["tables"]
    assert not {"bvh2", "stream2", "wide", "stream"} - {table} & set(
        run["tables"])
    assert run["plain_calls"] == 7              # 6 extension + 1 connection
    assert run["walk_calls"] == 0


@pytest.mark.parametrize("name", list(SELECTORS))
def test_selected_sample_matches_jax(samples, name):
    run, want = samples[0][name], samples[1]
    counts = run["ties"].differing_rays()
    assert max(counts) <= MAX_DIFFERING_RAYS, counts
    near = check_ties(run["ties"], W, H, samples=[0])
    for k in FIELDS:
        mask = np.zeros_like(near) if k == "summed_unidirectional" else near
        assert_match(run["got"][k], want[k], mask, k)
    assert run["got"]["summed_image"].mean() > 0


# ---- the dispatch ------------------------------------------------------------

def _soup_parts():
    rng = np.random.default_rng(41)
    mesh = (rng.uniform(-1, 1, (400, 1, 3))
            + rng.uniform(-0.2, 0.2, (400, 3, 3))).astype(np.float32)
    cam = ct.create_scene(pixel_width=4, pixel_height=4, device="cpu").camera
    soup = camera_geometry(cam) + box_geometry() + TorchSoup.from_vertices(
        mesh)
    return mesh, cam, soup


# (CLIVE2_TRAVERSAL, CLIVE2_STREAM_IMPL) -> table for (small, large) scenes
# on (CUDA, the CPU); None: the gather walk
DISPATCH = {
    (None, None): (("bvh2", None), ("stream2", "stream2")),
    (None, "1"): (("bvh2", None), ("stream", "stream")),
    (None, "2"): (("bvh2", None), ("stream2", "stream2")),
    ("wide", None): (("wide", "wide"), ("wide", "wide")),
    ("wide", "1"): (("wide", "wide"), ("wide", "wide")),
    ("pallas2", None): (("bvh2", None), ("bvh2", None)),
    ("pallas2", "1"): (("bvh2", None), ("bvh2", None)),
    ("stream", None): (("stream2", "stream2"), ("stream2", "stream2")),
    ("stream", "1"): (("stream", "stream"), ("stream", "stream")),
}


@pytest.mark.parametrize("selector", list(DISPATCH),
                         ids=[f"{a}-{b}" for a, b in DISPATCH])
def test_dispatch_matrix(monkeypatch, selector):
    """Each selector's table for a scene below and at STREAM2_MIN_TRIS
    world triangles, on CUDA and on the CPU; a scene holds at most one
    traversal table."""
    _, cam, soup = _soup_parts()
    n_world = int((~soup.is_camera).sum())
    for env, value in zip(("CLIVE2_TRAVERSAL", "CLIVE2_STREAM_IMPL"),
                          selector):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
    for size, want in zip(("small", "large"), DISPATCH[selector]):
        monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS",
                            n_world + (1 if size == "small" else 0))
        for cuda, table in zip((True, False), want):
            data, _, _ = port_scene._build_scene_arrays(
                soup, default_materials(), cam, cuda=cuda)
            got = sorted(set(data) & set(port_scene.PACKERS))
            assert got == ([table] if table else []), (size, cuda)


def test_unset_selectors_give_todays_tables(monkeypatch):
    """With neither variable set every scene gets the parent commit's
    tables: stream2 from STREAM2_MIN_TRIS world triangles on both devices,
    bvh2 below it on CUDA and nothing (the gather walk) on the CPU, packed
    exactly as before."""
    monkeypatch.delenv("CLIVE2_TRAVERSAL", raising=False)
    monkeypatch.delenv("CLIVE2_STREAM_IMPL", raising=False)
    _, cam, soup = _soup_parts()
    n_world = int((~soup.is_camera).sum())
    for limit, cuda, want in ((n_world, True, "stream2"),
                              (n_world, False, "stream2"),
                              (n_world + 1, True, "bvh2"),
                              (n_world + 1, False, None)):
        monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", limit)
        data, _, _ = port_scene._build_scene_arrays(
            soup, default_materials(), cam, cuda=cuda)
        got = sorted(set(data) & set(port_scene.PACKERS))
        assert got == ([want] if want else [])
        if want:
            rows = (data["bvh"]["node_packed"], data["bvh"]["leaf_packed"])
            for k, v in port_scene.PACKERS[want](*rows).items():
                np.testing.assert_array_equal(data[want][k], v, err_msg=k)


def test_unknown_traversal_raises(monkeypatch):
    """The JAX package routes an unknown CLIVE2_TRAVERSAL to its streaming
    kernels without a word; the port refuses it."""
    _, cam, soup = _soup_parts()
    monkeypatch.setenv("CLIVE2_TRAVERSAL", "bvh8")
    with pytest.raises(ValueError, match="CLIVE2_TRAVERSAL='bvh8'"):
        port_scene._build_scene_arrays(soup, default_materials(), cam,
                                       cuda=True)


def test_stream1_needs_no_force(monkeypatch):
    """The JAX package fences CLIVE2_STREAM_IMPL=1 behind
    CLIVE2_STREAM1_FORCE=1 (a TPU fault); the port selects it as asked."""
    monkeypatch.delenv("CLIVE2_TRAVERSAL", raising=False)
    monkeypatch.delenv("CLIVE2_STREAM1_FORCE", raising=False)
    monkeypatch.setenv("CLIVE2_STREAM_IMPL", "1")
    assert port_scene.selected_traversal(10 ** 6, cuda=True) == "stream"


@pytest.mark.parametrize("selector", [
    dict(CLIVE2_TRAVERSAL="wide"),
    dict(CLIVE2_TRAVERSAL="stream", CLIVE2_STREAM_IMPL="1"),
    dict(CLIVE2_TRAVERSAL="pallas2")], ids=["wide", "stream1", "pallas2"])
def test_converted_jax_scene_gets_the_same_tables(monkeypatch, selector):
    """convert.scene_data_from_jax packs a JAX scene's tables through
    scene.traversal_tables, under the same selectors, from the JAX scene's
    gather-walk rows: they equal the port's own build of the scene."""
    mesh, _, _ = _soup_parts()
    kw = dict(pixel_width=8, pixel_height=8, cam_center=[0, 1.5, 6],
              cam_direction=[0, 0, -1.0])
    js = c2.create_scene(extra_geometry=JaxSoup.from_vertices(mesh), **kw)
    for k, v in selector.items():
        monkeypatch.setenv(k, v)
    ts = ct.create_scene(extra_geometry=TorchSoup.from_vertices(mesh),
                         device="cpu", **kw)
    np_tree = jax.tree.map(np.asarray, js.data)
    for cuda in (False, True):
        converted = scene_data_from_jax(np_tree)
        if cuda:      # the CUDA build, packed without a card
            converted = dict(converted, **port_scene.to_device(
                port_scene.traversal_tables(
                    np_tree["bvh"], 0, cuda=True), "cpu"))
        table = {"wide": "wide", "stream": "stream",
                 "pallas2": "bvh2"}[selector["CLIVE2_TRAVERSAL"]]
        if table == "bvh2" and not cuda:
            assert not set(converted) & set(port_scene.PACKERS)
            continue
        mine = ts.data[table] if table in ts.data else port_scene.to_device(
            port_scene.traversal_tables(ts.data["bvh"], 0, cuda=True),
            "cpu")[table]
        for k, v in mine.items():
            np.testing.assert_array_equal(converted[table][k].numpy(),
                                          v.numpy(), err_msg=k)
