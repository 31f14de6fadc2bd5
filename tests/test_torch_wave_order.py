"""The Morton wave order (``CLIVE2_WAVE_ORDER``) against the JAX package on
the CPU.

* The permutations (``_morton_codes``, ``_morton_pixel_perm``,
  ``_banded_morton_perm``) equal the JAX package's, uneven bands included,
  and ``_wave_order``'s policy matrix is the JAX package's (without its
  tuned defaults; an unknown value raises).
* The reference's pairing fault: the JAX package pairs Morton camera lane j
  with the j-th light ray in ``light_gen_key`` order, so lane 0 always
  meets a light ray from the emitter's lowest position cell; the port puts
  the light subpaths back in generation order first, so lane 0 meets the
  light ray generated at lane 0.  A slow test shows the bias by block.
* Stage by stage under morton, on the icosphere BVH scene with its
  ``stream2`` table (``STREAM2_MIN_TRIS`` lowered; the extension casts then
  sort per cast): the JAX package's own functions composed as its morton
  branch, with the light subpaths put back in generation order before its
  ``connect_paths``, against the port's ``render_sample``.  Subpaths lane
  for lane, connection outputs and the sample at the golden tolerance
  outside near-tie lanes and pixels (tests/torch_parity.py).
* A stripe under morton, and each tile of a two-rank gloo mesh against the
  JAX package's banded layout (``_banded_morton_perm``, light rays sorted
  per band on the whole wavefront's key), lane for lane.
* ``utils/profiling`` on the CPU.
"""

import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.integrator import connect as jax_connect
from clive2_tpu.integrator import render as jax_render
from clive2_tpu.integrator import trace as jax_trace
from clive2_tpu.ops.filters import filter_weights, finalize_samples_scatter
from clive2_tpu_torch import constants, rng
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from clive2_tpu_torch.integrator import render, trace
from clive2_tpu_torch.testing import spawn_ranks
from clive2_tpu_torch.utils import profiling
from test_torch_slice import SEED, H, W, _bvh_scene
from torch_parity import (ATOL, MAX_DIFFERING_RAYS, NEAR_TIE_MAX, RTOL,
                          NearTies, assert_match, check_ties)

torch.set_num_threads(2)

SHAPES = [(8, 8), (24, 24), (7, 13), (54, 96), (1, 5)]
# (rows, width, bands): bands of whole rows, and bands that split rows
BANDED = [(16, 24, 8), (16, 16, 2), (9, 7, 3), (6, 10, 4), (5, 12, 6)]
INT_FIELDS = ("material", "triangle", "hit_light", "hit_camera")


# ---- permutations and policy ----------------------------------------------

@pytest.mark.parametrize("rows,width", SHAPES)
def test_morton_perm_matches_jax(rows, width):
    np.testing.assert_array_equal(render._morton_codes(rows, width),
                                  jax_render._morton_codes(rows, width))
    p = render._morton_pixel_perm(rows, width)
    np.testing.assert_array_equal(p, jax_render._morton_pixel_perm(rows,
                                                                   width))
    assert sorted(p.tolist()) == list(range(rows * width))


@pytest.mark.parametrize("rows,width,bands", BANDED)
def test_banded_perm_matches_jax(rows, width, bands):
    got = render._banded_morton_perm(rows, width, bands)
    np.testing.assert_array_equal(
        got, jax_render._banded_morton_perm(rows, width, bands))
    per = rows * width // bands
    assert got.shape == (bands, per)
    for b in range(bands):
        assert sorted(got[b].tolist()) == list(range(per))


@pytest.fixture(scope="module")
def cornell():
    return ct.create_scene_from_preset("empty", W, H, device="cpu")


@pytest.mark.parametrize("tables,want", [
    ((), "raster"), (("stream",), "morton"), (("stream2",), "morton"),
    (("bvh2",), "morton"), (("wide",), "morton")])
def test_policy_auto(monkeypatch, tables, want):
    """auto: morton exactly for a scene with a traversal table, under a
    mesh too (the JAX package's test_policy, whose pallas table is the
    port's bvh2)."""
    monkeypatch.delenv("CLIVE2_WAVE_ORDER", raising=False)
    monkeypatch.setenv("CLIVE2_TUNED", "0")   # the JAX package's defaults
    scene = {"tri": {}, **{t: {} for t in tables}}
    assert render._wave_order(scene) == want
    assert render._wave_order(scene, mesh=object()) == want
    if tables:
        jax_scene = {"pallas" if tables[0] == "bvh2" else tables[0]: {}}
        assert jax_render._wave_order(jax_scene) == want


def test_policy_of_built_scenes(monkeypatch, cornell):
    """The brute Cornell scene and a CPU BVH scene (the gather walk, no
    table) render raster; the same scene with its stream2 table morton."""
    monkeypatch.delenv("CLIVE2_WAVE_ORDER", raising=False)
    assert render._wave_order(cornell.data) == "raster"
    bvh = _bvh_scene(ct, TorchSoup, device="cpu")
    assert render._wave_order(bvh.data) == "raster"
    monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
    assert render._wave_order(_bvh_scene(ct, TorchSoup,
                                         device="cpu").data) == "morton"


@pytest.mark.parametrize("value,tables,want", [
    ("morton", (), "morton"), ("raster", ("stream2",), "raster"),
    ("", ("wide",), "morton"), ("auto", ("bvh2",), "morton")])
def test_policy_forced(monkeypatch, value, tables, want):
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", value)
    assert render._wave_order({t: {} for t in tables}) == want


def test_unknown_wave_order_raises(monkeypatch):
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "hilbert")
    with pytest.raises(ValueError, match="CLIVE2_WAVE_ORDER"):
        render._wave_order({"stream2": {}})


def test_uneven_tiles_fall_back_to_raster(monkeypatch, cornell):
    """A mesh whose tiles differ in rows renders raster; equal tiles keep
    the policy's order."""
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "morton")
    seen = []
    monkeypatch.setattr(render, "render_sample",
                        lambda *a, order=None, **k: seen.append(order) or
                        dict(image=torch.zeros(1), weight=torch.zeros(1),
                             unidirectional=torch.zeros(1),
                             n_rays=torch.zeros(())))
    for size in (3, 4):
        mesh = types.SimpleNamespace(rank=0, size=size, bounds=None,
                                     all_reduce_sum=lambda ts: ts)
        render.make_sharded_render(mesh, W, H)(rng.key(0), cornell.data)
    assert seen == ["raster", "morton"]


def test_subsets_and_per_strategy_images_stay_raster(cornell):
    with pytest.raises(ValueError, match="raster only"):
        render.trace_and_connect(rng.key(0), cornell.data, W, H,
                                 order="morton",
                                 pixel_sel=torch.arange(5,
                                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="raster only"):
        render.trace_and_connect(rng.key(0), cornell.data, W, H,
                                 order="morton", debug_per_strategy=True)


# ---- the reference's pairing fault ------------------------------------------

def test_reference_pairing_ties_lane_zero_to_the_lowest_light_cell():
    """Cornell ``empty`` at 32x32, 16 keys, generation and the light sort
    only.  Under the JAX package's pairing the light ray that Morton camera
    lane 0 connects to lies in the lowest occupied position cell of
    ``light_gen_key`` every time (pixel (0, 0) sees one corner of the
    emitter, every sample); under the port's pairing it is the light ray
    generated at lane 0, whose cell is the lowest only as often as chance
    gives (measured: 0 of 16 keys, 16 distinct cells of the emitter's
    64)."""
    n = 32 * 32
    js = c2.create_scene_from_preset("empty", 32, 32)
    ts = ct.create_scene_from_preset("empty", 32, 32, device="cpu")
    jax_low, port_low, port_cells = 0, 0, set()
    for seed in range(16):
        k_light = jax.random.split(jax.random.key(seed), 3)[1]
        lr = jax_trace.generate_light_rays(k_light, js.data["lights"],
                                           js.data["mat"], n)
        jcell = np.asarray(jax_trace.light_gen_key(
            lr["origin"], lr["direction"])) >> 21
        jax_low += int(jcell[np.asarray(jnp.argsort(
            jax_trace.light_gen_key(lr["origin"], lr["direction"])))[0]]
            == jcell.min())

        k_light = rng.split(rng.key(seed), 3)[1]
        rays = trace.generate_light_rays(k_light, ts.data["lights"],
                                         ts.data["mat"], n)
        key = trace.light_gen_key(rays["origin"], rays["direction"])
        lorder = render.ray_order(key)
        traced = dict(vertices={k: v[lorder][None] for k, v in rays.items()},
                      valid=torch.ones(1, n, dtype=torch.bool),
                      length=torch.ones(n, dtype=torch.int32)[lorder])
        paired = render.pair_lights(lorder, traced)
        lane0 = paired["vertices"]["origin"][0, 0]
        assert torch.equal(lane0, rays["origin"][0])
        cell = int(key[0]) >> 21
        port_low += cell == int((key >> 21).min())
        port_cells.add(cell)
        # the same light rays in both packages
        np.testing.assert_array_equal((key >> 21).numpy(), jcell)
    assert jax_low == 16
    assert port_low <= 4
    assert len(port_cells) >= 8


def _block_means(data, order, pairing, spp, seed):
    """2x2 block means of the 16x16 image over ``spp`` samples in
    ``order``, with the port's light pairing or, with ``pairing=False``,
    the JAX package's (light subpaths in sorted order)."""
    with pytest.MonkeyPatch.context() as mp:
        if not pairing:
            mp.setattr(render, "pair_lights", lambda lorder, path: path)
        img = wgt = 0
        for i in range(spp):
            s = render.render_sample(rng.fold_in(rng.key(seed), i), data,
                                     16, 16, order=order)
            img, wgt = img + s["image"], wgt + s["weight"]
    im = (img / torch.clamp(wgt, min=1e-6)[..., None]).numpy()
    return im.reshape(2, 8, 2, 8, 3).mean((1, 3, 4)), im.mean()


@pytest.mark.slow
def test_reference_pairing_biases_each_block():
    """The bias itself: Cornell ``empty`` at 16x16, 64 samples each,
    8x8-block means against a raster render, over the raster image's mean.
    Measured on the CPU: the JAX package's pairing 3.0-5.3% per block (a
    block's pixels keep connecting to one part of the emitter), the port's
    0.1-0.9%, a second raster render 0.3-0.7%."""
    data = ct.create_scene_from_preset("empty", 16, 16, device="cpu").data
    ref, mean = _block_means(data, "raster", True, 64, 1)
    dev = {name: float(np.abs(_block_means(data, *args)[0] - ref).max()
                       / mean)
           for name, args in (("port", ("morton", True, 64, 2)),
                              ("jax", ("morton", False, 64, 3)),
                              ("raster", ("raster", True, 64, 4)))}
    assert dev["jax"] > 0.02, dev
    assert dev["port"] < 0.02 and dev["raster"] < 0.02, dev


# ---- the JAX package's functions composed as its morton branch ---------------

def jax_morton(key, data, width, height, row0=0, rows=None, bands=1):
    """The JAX package's morton branch of render_sample
    (clive2_tpu/integrator/render.py:143-276), band-local as under its
    sharded step when ``bands`` > 1, with one change: the light subpaths go
    back to generation order before ``connect_paths``.  Returns the
    lane->pixel map, the light order (global lanes), the traced path, the
    subpaths as paired, the connection and the sample."""
    rows = height if rows is None else rows
    n = width * rows
    cam = data["camera"]
    k_cam, k_light, k_trace = jax.random.split(key, 3)
    cam_rays, pixel_idx = jax_trace.generate_camera_rays(
        k_cam, cam, width, height, row0=row0, rows=rows)
    light_rays = jax_trace.generate_light_rays(k_light, data["lights"],
                                               data["mat"], n)
    lkey = jax_trace.light_gen_key(light_rays["origin"],
                                   light_rays["direction"])
    per = n // bands
    idx = jnp.asarray(jax_render._banded_morton_perm(rows, width, bands))
    cam_rays = jax_render._banded_take(cam_rays, idx, bands)
    pixel_idx = jax_render._banded_take(pixel_idx, idx, bands)
    lord = jnp.argsort(lkey.reshape(bands, -1), axis=1)
    light_rays = jax_render._banded_take(light_rays, lord, bands)
    lorder = (lord + per * jnp.arange(bands)[:, None]).reshape(-1)
    merged = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), cam_rays,
                          light_rays)
    fc = jnp.arange(2 * n) < n
    path = jax_trace.trace_subpaths(k_trace, merged, data, from_camera=fc,
                                    sort=False)
    inv = jnp.argsort(lorder)
    cam_path = dict(
        vertices=jax.tree.map(lambda a: a[:, :n], path["vertices"]),
        valid=path["valid"][:, :n], length=path["length"][:n],
        n_rays=path["n_rays"])
    light_path = dict(
        vertices=jax.tree.map(lambda a: a[:, n:][:, inv], path["vertices"]),
        valid=path["valid"][:, n:][:, inv],
        length=path["length"][n:][inv], n_rays=jnp.int32(0))
    conn = jax_connect.connect_paths(cam_path, light_path, data, width,
                                     height, sort=False)
    weights = filter_weights(cam_rays["origin"], pixel_idx, cam, width,
                             height)
    image, wimage = finalize_samples_scatter(
        conn["contribution"], weights, conn["contrib_weight_sum"], pixel_idx,
        width, height)
    uni = jnp.zeros((height * width, 3)).at[pixel_idx].add(
        jax_trace.unidirectional_image(cam_path)).reshape(height, width, 3)
    sample = dict(
        image=jnp.nan_to_num(image + conn["light_image"], posinf=0.0,
                             neginf=0.0),
        weight=wimage + conn["light_weight_image"],
        unidirectional=jnp.nan_to_num(uni, posinf=0.0, neginf=0.0))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return dict(pixel_idx=np.asarray(pixel_idx), lorder=np.asarray(lorder),
                cam=to_np(cam_path), light=to_np(light_path),
                conn=to_np(conn), sample=to_np(sample))


def port_morton(key, data, width, height, **kw):
    """The port's render_sample with its connection's inputs and outputs
    and its lane->pixel map recorded."""
    got = {}
    orig_connect, orig_weights = render.connect_paths, render.filter_weights

    def connect(cam_path, light_path, *a, **k):
        got.update(cam=cam_path, light=light_path)
        got["conn"] = orig_connect(cam_path, light_path, *a, **k)
        return got["conn"]

    def weights(sensor_pos, pixel_idx, *a, **k):
        got["pixel_idx"] = pixel_idx.numpy()
        return orig_weights(sensor_pos, pixel_idx, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(render, "connect_paths", connect)
        mp.setattr(render, "filter_weights", weights)
        got["sample"] = render.render_sample(key, data, width, height, **kw)
    return got


def assert_lanes(got, want, skip, label):
    """Subpath fields lane for lane on the lanes outside ``skip``: ids
    exactly, floats at the golden tolerance."""
    for k, v in want["vertices"].items():
        g = got["vertices"][k].numpy()[:, ~skip]
        w = v[:, ~skip]
        if k in INT_FIELDS:
            np.testing.assert_array_equal(g, w, f"{label} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label} {k}")
    np.testing.assert_array_equal(got["valid"].numpy()[:, ~skip],
                                  want["valid"][:, ~skip], label)
    np.testing.assert_array_equal(got["length"].numpy()[~skip],
                                  want["length"][~skip], label)


@pytest.fixture(scope="module")
def stream2_morton():
    """One morton sample of the icosphere scene: the port on its stream2
    table (the auto order), the JAX package's pieces on its gather walk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
        mp.delenv("CLIVE2_WAVE_ORDER", raising=False)
        mp.delenv("CLIVE2_TRACE_SORT", raising=False)
        ts = _bvh_scene(ct, TorchSoup, device="cpu")
        assert "stream2" in ts.data
        assert render._wave_order(ts.data) == "morton"
        js = _bvh_scene(c2, JaxSoup)
        sorted_casts = []
        orig = trace.intersect_scene

        def spy(*a, **k):
            sorted_casts.append(k["sort"])
            return orig(*a, **k)

        mp.setattr(trace, "intersect_scene", spy)
        with NearTies() as ties:
            want = jax_morton(jax.random.key(SEED), js.data, W, H)
            got = port_morton(rng.key(SEED), ts.data, W, H)
    return dict(want=want, got=got, ties=ties, sorts=sorted_casts)


def test_morton_branch_sorts_the_streaming_extension_casts(stream2_morton):
    """Extension casts keep intersect_scene's default (sorted on stream2),
    as the JAX package's morton branch passes them."""
    assert stream2_morton["sorts"] == [None] * 6


def test_morton_lanes_hold_the_jax_pixels(stream2_morton):
    got, want = stream2_morton["got"], stream2_morton["want"]
    np.testing.assert_array_equal(got["pixel_idx"], want["pixel_idx"])
    np.testing.assert_array_equal(
        got["pixel_idx"], render._morton_pixel_perm(H, W))


def test_morton_subpaths_match_jax_lane_for_lane(stream2_morton):
    s = stream2_morton
    near = s["ties"].slots(0)
    assert near.mean() < 0.1, near.mean()
    assert_lanes(s["got"]["cam"], s["want"]["cam"], near, "camera")
    assert_lanes(s["got"]["light"], s["want"]["light"], near, "light")


def test_morton_connection_and_sample_match_jax(stream2_morton):
    s = stream2_morton
    slots = s["ties"].slots(0)
    near = check_ties(s["ties"], W, H)
    got, want = s["got"]["conn"], s["want"]["conn"]
    for k in ("contribution", "contrib_weight_sum"):
        np.testing.assert_allclose(got[k].numpy()[~slots], want[k][~slots],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("light_image", "light_weight_image"):
        assert_match(got[k].numpy(), want[k], near, k)
    for k in ("image", "weight"):
        assert_match(s["got"]["sample"][k].numpy(), s["want"]["sample"][k],
                     near, k)
    assert_match(s["got"]["sample"]["unidirectional"].numpy(),
                 s["want"]["sample"]["unidirectional"], np.zeros_like(near),
                 "unidirectional")
    assert s["got"]["sample"]["image"].sum() > 0


def test_morton_stripe_matches_jax(monkeypatch):
    """Rows 8-15 of the 16x16 frame: the stripe's own Morton order over
    its 8 x 16 grid, the gather walk (forced morton) on both sides."""
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "morton")
    ts = _bvh_scene(ct, TorchSoup, device="cpu")
    js = _bvh_scene(c2, JaxSoup)
    with NearTies() as ties:
        want = jax_morton(jax.random.key(SEED + 1), js.data, W, H, row0=8,
                          rows=8)
        got = port_morton(rng.key(SEED + 1), ts.data, W, H, row0=8, rows=8)
    np.testing.assert_array_equal(got["pixel_idx"], want["pixel_idx"])
    assert sorted(got["pixel_idx"].tolist()) == list(range(8 * W, H * W))
    near = check_ties(ties, W, H)
    slots = ties.slots(0)
    assert_lanes(got["cam"], want["cam"], slots, "camera")
    assert_lanes(got["light"], want["light"], slots, "light")
    for k in ("image", "weight"):
        assert_match(got["sample"][k].numpy(), want["sample"][k], near, k)
    assert_match(got["sample"]["unidirectional"].numpy(),
                 want["sample"]["unidirectional"], np.zeros_like(near),
                 "unidirectional")


# ---- two gloo ranks against the JAX package's banded layout -----------------

def _recording(module, name, out, item=0):
    """Patch ``module.name`` to append item ``item`` of each result, as a
    numpy array, to ``out``; returns the original."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(np.asarray(res[item]))
        return res

    setattr(module, name, wrapped)
    return fn


def _morton_ranks(rank, size, workdir):
    """Each rank: its tile through trace_and_connect (morton, light bounds
    over the mesh) with its subpaths, connection cast ids and splat pixels
    recorded, then the mesh step's summed sample."""
    from clive2_tpu_torch.integrator import connect
    from clive2_tpu_torch.parallel import make_tile_mesh
    from clive2_tpu_torch.parallel.mesh import tile_rows

    torch.set_num_threads(1)
    mesh = make_tile_mesh(n_devices=size, devices="cpu")
    data = _bvh_scene(ct, TorchSoup, device="cpu").data
    key = rng.key(SEED + 2)
    t0, t_rows = tile_rows(mesh, H)
    got, casts, splats = {}, [], []

    def grab(cam_path, light_path, *a, **k):
        got.update(cam=cam_path, light=light_path)
        return orig_connect(cam_path, light_path, *a, **k)

    orig_connect, render.connect_paths = render.connect_paths, grab
    orig_cast = _recording(connect, "intersect_scene", casts)
    orig_t1 = _recording(connect, "_strategy_t1", splats)
    try:
        pixel_idx, _, _, conn, _ = render.trace_and_connect(
            key, data, W, H, tile=(t0, t_rows), order="morton",
            light_bounds=mesh.bounds, row0=0, rows=H)
    finally:
        render.connect_paths = orig_connect
        connect.intersect_scene, connect._strategy_t1 = orig_cast, orig_t1
    sample = render.make_sharded_render(mesh, W, H)(key, data)
    out = dict(pixel_idx=pixel_idx.numpy(),
               contribution=conn["contribution"].numpy(),
               conn_ids=casts[0], splats=np.stack(splats),
               **{f"sample/{k}": sample[k].numpy()
                  for k in ("image", "weight", "unidirectional")})
    for side in ("cam", "light"):
        p = got[side]
        out.update({f"{side}/{k}": v.numpy()
                    for k, v in p["vertices"].items()})
        out[f"{side}/valid"] = p["valid"].numpy()
        out[f"{side}/length"] = p["length"].numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def banded():
    """Two gloo ranks' tiles, and the JAX package's banded layout with its
    connection cast ids and splat pixels recorded (its connection runs op
    by op, so they are plain arrays)."""
    with pytest.MonkeyPatch.context() as mp, \
            tempfile.TemporaryDirectory() as workdir:
        mp.setenv("CLIVE2_WAVE_ORDER", "morton")
        spawn_ranks(_morton_ranks, 2, workdir, timeout=240)
        ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(2)]
    js = _bvh_scene(c2, JaxSoup)
    casts, splats = [], []
    orig_cast = _recording(jax_connect, "intersect_scene", casts)
    orig_t1 = _recording(jax_connect, "_strategy_t1", splats)
    try:
        want = jax_morton(jax.random.key(SEED + 2), js.data, W, H, bands=2)
    finally:
        jax_connect.intersect_scene = orig_cast
        jax_connect._strategy_t1 = orig_t1
    want.update(conn_ids=casts[0], splats=np.stack(splats))
    return ranks, want


def _band_slots(got, want, band):
    """The rank's lanes whose connection casts differ from the JAX band's:
    near ties (measured: 7 of the 256 lanes, none in the extension
    casts)."""
    p = want["splats"].shape[0]
    per = got["pixel_idx"].size
    ours = got["conn_ids"].reshape(-1, per)
    theirs = want["conn_ids"].reshape(ours.shape[0], -1)[:, band]
    assert ours.shape[0] == 36 and p == 6
    return (ours != theirs).any(0)


def test_mesh_tiles_match_jax_banded_layout(banded):
    """Rank r's lanes are band r of the JAX package's banded layout, lane
    for lane: pixels, subpaths on every lane (their casts' ids measured
    equal), and connection contributions outside near-tie lanes."""
    ranks, want = banded
    per = W * H // 2
    n_near = 0
    for r, got in enumerate(ranks):
        band = slice(r * per, (r + 1) * per)
        np.testing.assert_array_equal(got["pixel_idx"],
                                      want["pixel_idx"][band])
        for side in ("cam", "light"):
            fields = {k.split("/", 1)[1]: v for k, v in got.items()
                      if k.startswith(f"{side}/")}
            path = dict(valid=torch.from_numpy(fields.pop("valid")),
                        length=torch.from_numpy(fields.pop("length")),
                        vertices={k: torch.from_numpy(v)
                                  for k, v in fields.items()})
            w = want[side]
            sub = dict(vertices={k: v[:, band]
                                 for k, v in w["vertices"].items()},
                       valid=w["valid"][:, band], length=w["length"][band])
            assert_lanes(path, sub, np.zeros(per, bool), f"rank {r} {side}")
        slots = _band_slots(got, want, band)
        n_near += int(slots.sum())
        np.testing.assert_allclose(
            got["contribution"][~slots],
            want["conn"]["contribution"][band][~slots], rtol=RTOL, atol=ATOL)
    assert n_near <= MAX_DIFFERING_RAYS


def test_mesh_sample_matches_jax_banded_sample(banded):
    """The mesh step's sample is the same on both ranks and matches the
    JAX package's banded sample at the golden tolerance outside the pixels
    the near-tie lanes reach (their filter footprints and splats)."""
    ranks, want = banded
    per = W * H // 2
    seed, splat = np.zeros(W * H, bool), np.zeros(W * H, bool)
    for r, got in enumerate(ranks):
        band = slice(r * per, (r + 1) * per)
        slots = _band_slots(got, want, band)
        seed[got["pixel_idx"][slots]] = True
        for pix in (got["splats"][:, slots],
                    want["splats"][:, band][:, slots]):
            splat[pix[pix < W * H]] = True
    img = np.pad(seed.reshape(H, W), 1)
    near = splat.reshape(H, W).copy()
    for dy in range(3):
        for dx in range(3):
            near |= img[dy:dy + H, dx:dx + W]
    assert near.mean() <= NEAR_TIE_MAX
    for k in ("image", "weight", "unidirectional"):
        np.testing.assert_array_equal(ranks[0][f"sample/{k}"],
                                      ranks[1][f"sample/{k}"])
        assert_match(ranks[0][f"sample/{k}"], want["sample"][k],
                     np.zeros_like(near) if k == "unidirectional" else near,
                     k)


# ---- utils/profiling --------------------------------------------------------

def test_profiling_runs_on_the_cpu(tmp_path, capsys):
    held = {}
    with profiling.stage_timer("sum", held):
        torch.ones(1000).sum()
    assert held["sum"] > 0
    with profiling.stage_timer("printed"):
        pass
    assert "[stage printed]" in capsys.readouterr().out
    with profiling.trace_to(str(tmp_path)) as prof:
        torch.ones(256, 256) @ torch.ones(256, 256)
    assert (tmp_path / profiling.TRACE_FILE).exists()
    assert any("mm" in e.key for e in prof.key_averages())
    busy = profiling.device_busy(str(tmp_path))
    assert busy["device_events"] == 0 and busy["share"] == 0.0
    assert busy["window_ms"] > 0
    assert profiling.device_memory_stats() == {"cpu": {}}
    assert profiling.timed is constants.timed
