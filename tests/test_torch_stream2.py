"""The fat-leaf traversal (clive2_tpu_torch/ops/traverse_stream2.py) against
the JAX package on the CPU.

* the cut and the top tree equal ``clive2_tpu.ops.traverse_stream``'s on
  the same BVH, and the slots cover every world triangle once;
* the f32 bilinear features equal the sum of the JAX packer's three bf16
  sections (b1 + b2 + b3) within 2^-20 relative;
* ``stream2_plain`` matches the JAX kernel in interpret mode and the gather
  walk at the JAX package's own tolerance (tests/test_pallas_kernels.py:
  ``_assert_mostly_equal``: at most 0.2% of ids differ, t to 2e-5 and u, v
  to 2e-4 on agreeing rays).  Both sides compute in f32 or near it (the
  JAX kernel's bf16x6 split), and on these sets 0 ids differ against
  either: the gather walk must stay at 0, the JAX kernel within the
  JAX package's bound;
* the JAX packer's scene path reads its u, v, t recovery rows by global id
  from arrays without the sensor plane; the port reads the winner's row;
* a converted JAX scene gets the same tables as the port's own build.

The kernel's own walk runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu.bvh.build import build_bvh as jax_build_bvh
from clive2_tpu.bvh.build import leaf_tables as jax_leaf_tables
from clive2_tpu.camera import Camera as JaxCamera
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.geometry import box_geometry, camera_geometry
from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_stream as jax_stream
from clive2_tpu.ops import traverse_stream2 as jax_stream2
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.convert import scene_data_from_jax
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.ops import intersect
from clive2_tpu_torch.ops import traverse_stream2 as s2
from test_torch_intersect import _rays, _soup, _t

torch.set_num_threads(2)

MAX_MISMATCH = 0.002          # tests/test_pallas_kernels.py:429


def _jax_tree(verts):
    """The JAX package's BVH and gather-walk rows of a camera-free soup."""
    soup = JaxSoup.from_vertices(verts)
    bvh = jax_build_bvh(soup)
    rows = jax_isect.pack_gather_walk(bvh, jax_leaf_tables(bvh, soup))
    return soup, bvh, rows


def _port_tables(rows, blocks_per_leaf=1):
    return {k: _t(v) for k, v in s2.pack_stream2(
        rows["node_packed"], rows["leaf_packed"],
        blocks_per_leaf=blocks_per_leaf).items()}


def _mismatch(got, want, label):
    """The JAX package's stream2 tolerance; returns the id mismatch share."""
    gi, gt, gu, gv = (np.asarray(a) for a in got)
    wi, wt, wu, wv = (np.asarray(a) for a in want)
    mismatch = float((gi != wi).mean())
    assert mismatch <= MAX_MISMATCH, f"{label}: {mismatch:.2%} ids differ"
    same = (gi == wi) & (wi >= 0)
    np.testing.assert_allclose(gt[same], wt[same], rtol=2e-5, atol=2e-5,
                               err_msg=f"{label}: t")
    np.testing.assert_allclose(gu[same], wu[same], rtol=2e-4, atol=2e-4,
                               err_msg=f"{label}: u")
    np.testing.assert_allclose(gv[same], wv[same], rtol=2e-4, atol=2e-4,
                               err_msg=f"{label}: v")
    miss_both = (gi < 0) & (wi < 0)
    assert not np.isfinite(gt[miss_both]).any(), f"{label}: finite t on misses"
    return mismatch


# ---- packer ------------------------------------------------------------------

@pytest.mark.parametrize("max_subleaves", [16, 32])
def test_cut_mask_matches_jax(max_subleaves):
    _, bvh, _ = _jax_tree(_soup(np.random.default_rng(11), 1500))
    want = jax_stream._cut_mask(bvh, max_subleaves)
    got = s2._cut_mask(bvh.miss, bvh.leaf_id, max_subleaves)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() > 4


def test_too_small_a_scene_is_refused():
    _, bvh, rows = _jax_tree(_soup(np.random.default_rng(12), 60))
    with pytest.raises(ValueError, match="too small"):
        s2.pack_stream2(rows["node_packed"], rows["leaf_packed"])


@pytest.mark.parametrize("blocks_per_leaf", [1, 2])
def test_top_tree_and_slots_match_jax(blocks_per_leaf):
    """Same cut, same child encoding as the JAX packer; each fat leaf holds
    the JAX fat leaf's triangles, and the slots cover every triangle of the
    soup exactly once (JAX: test_slots_cover_all_triangles)."""
    verts = _soup(np.random.default_rng(13), 777)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_stream2.pack_stream2(bvh, soup,
                                    blocks_per_leaf=blocks_per_leaf)
    got = s2.pack_stream2(rows["node_packed"], rows["leaf_packed"],
                          blocks_per_leaf=blocks_per_leaf)
    np.testing.assert_array_equal(got["childs"].ravel(), want["childs"])
    cols = 128 * blocks_per_leaf
    jax_slots = want["slot_tri"].reshape(-1, cols)
    for f in range(len(got["fat_start"]) - 1):
        mine = got["slot_tri"][got["fat_start"][f]:got["fat_start"][f + 1]]
        theirs = jax_slots[f][jax_slots[f] >= 0]
        np.testing.assert_array_equal(mine, theirs)
    assert sorted(got["slot_tri"].tolist()) == list(range(len(verts)))
    np.testing.assert_array_equal(got["slot_mt"][:, 0:3],
                                  verts[got["slot_tri"], 0])


def test_features_equal_the_jax_bf16_sections_summed():
    verts = _soup(np.random.default_rng(14), 900)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_stream2.pack_stream2(bvh, soup)
    got = s2.pack_stream2(rows["node_packed"], rows["leaf_packed"])
    np.testing.assert_array_equal(got["ctr"], want["ctr"])
    blocks = np.asarray(want["leafblocks"]).astype(np.float32)
    lv = jax_stream2.LIVE
    b1, b2, b3 = (blocks[:, k * lv:(k + 1) * lv] for k in (0, 3, 5))
    dense = b1 + b2 + b3                           # pack_stream2 :1043-1048
    cols = 128
    n_fat = dense.shape[0]
    group = dense.reshape(n_fat, lv, 4, cols)      # [fat, row, group, slot]
    coeff = np.concatenate([
        group[:, 0:3, 0], group[:, 0:6, 1], group[:, 0:6, 2],
        group[:, 6:10, 3]], axis=1)                 # [fat, 19, slot]
    coeff = coeff.transpose(0, 2, 1).reshape(n_fat * cols, 19)
    slot_tri = want["slot_tri"]
    by_tri = np.empty((len(verts), 19), np.float32)
    by_tri[slot_tri[slot_tri >= 0]] = coeff[slot_tri >= 0]
    mine = got["feat"][:, :19]
    theirs = by_tri[got["slot_tri"]]
    np.testing.assert_allclose(mine, theirs, rtol=2.0 ** -20, atol=0)
    assert (got["feat"][:, 19] == 0).all()


def test_top_tree_depth_bound_enforced(monkeypatch):
    _, _, rows = _jax_tree(_soup(np.random.default_rng(15), 900))
    s2.pack_stream2(rows["node_packed"], rows["leaf_packed"])
    monkeypatch.setattr(s2, "STACK_SIZE", 2)
    with pytest.raises(ValueError, match="exceeds the fat-leaf kernel's"):
        s2.pack_stream2(rows["node_packed"], rows["leaf_packed"])


# ---- stream2_plain against the JAX kernel and the gather walk ----------------

CASES = {
    # name: (triangles, rays, blocks_per_leaf, masked, capped, any_hit)
    "closest": (900, 500, 1, False, False, False),
    "masked": (600, 400, 1, True, False, False),
    "t_max": (900, 400, 1, False, True, False),
    "any_hit": (900, 500, 1, True, True, True),
    "two_blocks": (1200, 500, 2, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_and_gather_walk(case):
    t, n, bpl, masked, capped, any_hit = CASES[case]
    rng = np.random.default_rng(20 + list(CASES).index(case))
    verts = _soup(rng, t)
    soup, bvh, rows = _jax_tree(verts)
    o, d = _rays(rng, n)
    active = rng.uniform(size=n) < 0.6 if masked else None
    t_max = rng.uniform(1.0, 14.0, n).astype(np.float32) if capped else None
    jkw = dict(active=None if active is None else jnp.asarray(active),
               t_max=None if t_max is None else jnp.asarray(t_max))
    tkw = dict(active=None if active is None else _t(active),
               t_max=None if t_max is None else _t(t_max))

    packed = {k: jnp.asarray(v) for k, v in jax_stream2.pack_stream2(
        bvh, soup, blocks_per_leaf=bpl).items()}
    ref = jax_stream2.intersect_stream2(jnp.asarray(o), jnp.asarray(d),
                                        packed, interpret=True,
                                        any_hit=any_hit, **jkw)
    walk = intersect.intersect_bvh_packed(
        _t(o), _t(d), {k: _t(v) for k, v in rows.items()}, **tkw)
    calls = s2.stream2_plain.calls
    got = s2.intersect_stream2(_t(o), _t(d),
                               {"stream2": _port_tables(rows, bpl)},
                               any_hit=any_hit, **tkw)
    assert s2.stream2_plain.calls == calls + 1
    if active is not None:
        assert (got[0].numpy()[~active] == -1).all()
    if any_hit:
        # blocked set equal to the oracle's, hits genuine and under the cap
        blocked = walk[0].numpy() >= 0
        np.testing.assert_array_equal(got[0].numpy() >= 0, blocked)
        assert ((np.asarray(ref[0]) >= 0) != blocked).mean() <= MAX_MISMATCH
        hit = got[0].numpy() >= 0
        assert (got[1].numpy()[hit] < t_max[hit] + 1e-6).all()
        assert (got[1].numpy()[hit] >= walk[1].numpy()[hit] - 1e-5).all()
        return
    assert _mismatch(got, walk, f"{case} vs gather walk") == 0.0
    _mismatch(got, ref, f"{case} vs jax interpret")
    if capped:
        hit = got[0].numpy() >= 0
        assert (got[1].numpy()[hit] <= t_max[hit] * 1.0001).all()


def test_walk_equals_the_exhaustive_t_slot_minimum():
    """The (t, slot) rule makes the answer independent of visit order and
    pruning: the walk returns, on every ray, the lexicographic minimum of
    (t, slot) over every slot of every fat leaf.  Every triangle appears
    twice, so each hit is an exact tie that the lower slot must win."""
    rng = np.random.default_rng(30)
    base = _soup(rng, 700)
    rows = _jax_tree(np.concatenate([base, base]))[2]
    tables = _port_tables(rows)
    o, _ = _rays(rng, 1500)
    d = rng.uniform(-5, 5, (1500, 3)).astype(np.float32) - o   # at the soup
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = s2.stream2_plain(_t(o), _t(d), tables)

    fat_start = tables["fat_start"].numpy()
    width = int(np.diff(fat_start).max())
    osh, dd = _t(o) - tables["ctr"], _t(d)
    m = torch.stack([osh[:, 1] * dd[:, 2] - osh[:, 2] * dd[:, 1],
                     osh[:, 2] * dd[:, 0] - osh[:, 0] * dd[:, 2],
                     osh[:, 0] * dd[:, 1] - osh[:, 1] * dd[:, 0]], 1)
    best_t = torch.full((len(o),), float("inf"))
    best = torch.full((len(o),), -1, dtype=torch.int64)
    for f in range(len(fat_start) - 1):      # fat leaves in slot order
        t, slot = s2._leaf_best(tables, torch.full((len(o),), f),
                                dd.unbind(-1), m.unbind(-1),
                                osh.unbind(-1), width)
        better = t < best_t                  # a tie keeps the lower slot
        best_t = torch.where(better, t, best_t)
        best = torch.where(better, slot, best)
    want = torch.where(best >= 0, tables["slot_tri"][best.clamp(min=0)], -1)
    np.testing.assert_array_equal(got[0].numpy(), want.numpy())
    hit = want.numpy() >= 0
    assert hit.sum() > 200
    slot_of = np.empty(1400, np.int64)
    slot_of[tables["slot_tri"].numpy()] = np.arange(1400)
    k = want.numpy()[hit] % 700
    assert (slot_of[want.numpy()[hit]]
            == np.minimum(slot_of[k], slot_of[k + 700])).all()


# ---- the reference's scene-path fault ----------------------------------------

def _cornell_with_mesh(rng, t=1200):
    """A JAX soup as create_scene assembles it: sensor plane, room, mesh."""
    cam = JaxCamera(center=np.array([0, 1.5, 6.0]),
                    direction=np.array([0, 0, -1.0]), pixel_width=16,
                    pixel_height=16, phys_width=1.0, phys_height=1.0)
    mesh = _soup(rng, t, spread=1.5, size=0.2) + np.float32([0, 1.5, 0])
    return cam, (camera_geometry(cam) + box_geometry()
                 + JaxSoup.from_vertices(mesh))


def test_reference_scene_pack_reads_the_wrong_triangle():
    """clive2_tpu/scene.py packs stream2 from the world soup (no sensor
    plane) with global leaf ids, so its recovery arrays tri_v0/e1/e2 are
    indexed by global id into world rows: every id past the sensor
    triangles reads a triangle further on, the last ones run off the end."""
    _, soup = _cornell_with_mesh(np.random.default_rng(31))
    cam_ids = np.nonzero(soup.is_camera)[0]
    world_sel = np.nonzero(~soup.is_camera)[0]
    world = soup.select(world_sel)
    bvh = jax_build_bvh(world)
    leafs = jax_leaf_tables(bvh, world)
    leafs["tri_index"] = np.where(            # clive2_tpu/scene.py:176-180
        leafs["tri_index"] >= 0,
        world_sel[np.minimum(leafs["tri_index"], len(world) - 1)],
        -1).astype(np.int32)
    packed = jax_stream2.pack_stream2(bvh, world, leaf=leafs)
    ids = packed["slot_tri"][packed["slot_tri"] >= 0]
    assert len(cam_ids) > 0 and len(packed["tri_v0"]) == len(world)
    assert ids.max() == len(soup) - 1 >= len(packed["tri_v0"])
    inside = ids[ids < len(packed["tri_v0"])]
    wrong = (packed["tri_v0"][inside] != soup.vertices[inside, 0]).any(1)
    assert wrong.mean() > 0.9


def test_port_recovers_the_winners_own_triangle(monkeypatch):
    """On a scene that carries the sensor plane, the port's t, u, v equal
    the gather walk's on every ray (ids agree on all of them)."""
    monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", 0)
    rng = np.random.default_rng(32)
    mesh = _soup(rng, 1200, spread=1.5, size=0.2) + np.float32([0, 1.5, 0])
    scene = ct.create_scene(pixel_width=16, pixel_height=16,
                            cam_center=[0, 1.5, 6], cam_direction=[0, 0, -1.0],
                            extra_geometry=TriangleSoup.from_vertices(mesh),
                            device="cpu")
    assert "stream2" in scene.data and "bvh2" not in scene.data
    assert len(scene.camera_tri_ids) > 0
    o = np.broadcast_to(np.float32([0, 1.5, 5.5]), (800, 3)).copy()
    d = rng.normal(size=(800, 3)).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = s2.intersect_stream2(_t(o), _t(d), scene.data)
    want = intersect.intersect_bvh_packed(_t(o), _t(d), scene.data["bvh"])
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    hit = want[0].numpy() >= 0
    assert hit.sum() > 200 and not np.isin(got[0].numpy(),
                                           scene.camera_tri_ids).any()
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy()[hit], b.numpy()[hit])
    full = intersect.intersect_scene(_t(o), _t(d), scene.data)
    np.testing.assert_array_equal(full[0].numpy(), got[0].numpy())


def test_converted_jax_scene_gets_the_same_stream2_tables(monkeypatch):
    """convert.scene_data_from_jax packs stream2 from the JAX scene's
    gather-walk rows, for the CPU and for CUDA alike, and never reads the
    JAX package's TPU tables."""
    monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", 300)
    rng = np.random.default_rng(33)
    mesh = _soup(rng, 400, spread=1.5, size=0.2) + np.float32([0, 1.5, 0])
    kw = dict(pixel_width=8, pixel_height=8, cam_center=[0, 1.5, 6],
              cam_direction=[0, 0, -1.0])
    js = c2.create_scene(extra_geometry=JaxSoup.from_vertices(mesh), **kw)
    ts = ct.create_scene(extra_geometry=TriangleSoup.from_vertices(mesh),
                         device="cpu", **kw)
    converted = scene_data_from_jax(jax.tree.map(np.asarray, js.data))
    assert "bvh2" not in converted and "stream2" not in js.data
    for k, v in ts.data["stream2"].items():
        np.testing.assert_array_equal(converted["stream2"][k].numpy(),
                                      v.numpy(), err_msg=k)
    monkeypatch.setattr(port_scene, "STREAM2_MIN_TRIS", 10_000)
    assert "stream2" not in scene_data_from_jax(
        jax.tree.map(np.asarray, js.data))



def test_kernel_wrapper_checks_its_tables_and_device():
    rows = _jax_tree(_soup(np.random.default_rng(34), 900))[2]
    tables = {k: v.to("meta") for k, v in _port_tables(rows).items()}
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="table feat"):
        s2.intersect_stream2(o, o, {"stream2": dict(
            tables, feat=tables["feat"][:, :19])})
    with pytest.raises(ValueError, match="table childs"):
        s2.intersect_stream2(o, o, {"stream2": dict(
            tables, childs=tables["childs"].long())})
    with pytest.raises(ValueError, match="CUDA tensors"):
        s2.intersect_stream2(o, o, {"stream2": tables})
