"""The port's intersection modules against the JAX package, on the CPU.

* brute: the plain version of the brute kernel against JAX's Pallas brute
  kernel (interpret mode, as tests/test_pallas_kernels.py runs it) and
  against JAX's CPU path ``intersect_brute_chunked``;
* the gather walk (the BVH2 kernel's plain version) against JAX's
  ``intersect_bvh_packed``;
* the BVH2 packer: the tables the kernel walks reach every triangle once,
  their boxes bound their subtrees and their leaf rows are the soup's own
  (the kernel's walk is checked on the card, tests/test_torch_cuda.py),
  and the wrapper takes the gather walk for CPU tensors;
* ``intersect_scene`` on a BVH scene, sensor-plane merge included.

Ids must agree on every ray; t/u/v to rtol 1e-5 on hits.  The barycentrics
u, v also get atol 1e-5: they are O(1), and where s.h cancels XLA's fused
multiply-adds move them by a few 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu.bvh.build import build_bvh as jax_build_bvh
from clive2_tpu.bvh.build import leaf_tables as jax_leaf_tables
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.models import icosphere
from clive2_tpu.ops import brute_pallas as jax_bp
from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu_torch.bvh.build import build_bvh, leaf_tables
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.models import utah_teapot
from clive2_tpu_torch.ops import brute, intersect, traverse_bvh2

torch.set_num_threads(2)

INF = float("inf")


def _soup(rng, t, spread=5.0, size=0.4):
    centers = rng.uniform(-spread, spread, (t, 1, 3))
    return (centers + rng.uniform(-size, size, (t, 3, 3))).astype(np.float32)


def _rays(rng, n, spread=8.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _caps(rng, n):
    active = rng.uniform(size=n) < 0.7
    t_max = np.where(rng.uniform(size=n) < 0.5, INF,
                     rng.uniform(0.5, 12.0, n)).astype(np.float32)
    return active, t_max


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_hits(got, want, label, closest=True):
    gi, gt, gu, gv = (np.asarray(a) for a in got)
    wi, wt, wu, wv = (np.asarray(a) for a in want)
    if not closest:
        np.testing.assert_array_equal(gi >= 0, wi >= 0, err_msg=label)
        return
    np.testing.assert_array_equal(gi, wi, err_msg=f"{label}: ids")
    hit = wi >= 0
    for name, a, b, atol in (("t", gt, wt, 1e-6), ("u", gu, wu, 1e-5),
                             ("v", gv, wv, 1e-5)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=atol,
                                   err_msg=f"{label}: {name}")
    assert not np.isfinite(gt[~hit]).any(), f"{label}: finite t on a miss"


# ---- brute ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_brute_plain_matches_pallas_kernel(masked):
    rng = np.random.default_rng(1)
    verts = _soup(rng, 37)
    o, d = _rays(rng, 700)
    active, t_max = _caps(rng, 700) if masked else (None, None)
    packed = {k: jnp.asarray(v) for k, v in
              jax_bp.pack_brute(JaxSoup.from_vertices(verts)).items()}
    with pltpu.force_tpu_interpret_mode():
        want = jax_bp.intersect_brute_pallas(
            jnp.asarray(o), jnp.asarray(d), packed,
            active=None if active is None else jnp.asarray(active),
            t_max=None if t_max is None else jnp.asarray(t_max))
    tris = _t(brute.pack_brute(TriangleSoup.from_vertices(verts)))
    got = brute.intersect_brute(
        _t(o), _t(d), tris, active=None if active is None else _t(active),
        t_max=None if t_max is None else _t(t_max))
    _assert_hits(got, want, "brute vs pallas")


def test_brute_plain_matches_chunked_xla_path():
    rng = np.random.default_rng(2)
    verts = _soup(rng, 50)
    o, d = _rays(rng, 900)
    active, t_max = _caps(rng, 900)
    pad = np.zeros((64, 3, 3), np.float32)
    pad[:50] = verts
    table = dict(v0=jnp.asarray(pad[:, 0]), e1=jnp.asarray(pad[:, 1] - pad[:, 0]),
                 e2=jnp.asarray(pad[:, 2] - pad[:, 0]))
    want = jax_isect.intersect_brute_chunked(
        jnp.asarray(o), jnp.asarray(d), table, active=jnp.asarray(active),
        t_max=jnp.asarray(t_max))
    got = brute.intersect_brute(
        _t(o), _t(d), _t(brute.pack_brute(TriangleSoup.from_vertices(verts))),
        active=_t(active), t_max=_t(t_max))
    _assert_hits(got, want, "brute vs chunked")


# ---- gather walk ------------------------------------------------------------

def _bvh_tables(verts):
    soup = TriangleSoup.from_vertices(verts)
    bvh = build_bvh(soup)
    return intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))


def _camera_rays(rng, n, eye=(0.0, 0.0, 12.0)):
    """A coherent fan from one point, like a camera's primary rays."""
    d = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.broadcast_to(np.float32(eye), d.shape).copy(), d


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["random", "camera"])
def test_gather_walk_matches_jax(masked, kind):
    rng = np.random.default_rng(3)
    verts = _soup(rng, 600)
    o, d = _rays(rng, 1500) if kind == "random" else _camera_rays(rng, 1500)
    active, t_max = _caps(rng, 1500) if masked else (None, None)
    jsoup = JaxSoup.from_vertices(verts)
    jbvh = jax_build_bvh(jsoup)
    jtab = {k: jnp.asarray(v) for k, v in jax_isect.pack_gather_walk(
        jbvh, jax_leaf_tables(jbvh, jsoup)).items()}
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d), jtab,
        active=None if active is None else jnp.asarray(active),
        t_max=None if t_max is None else jnp.asarray(t_max))
    tab = {k: _t(v) for k, v in _bvh_tables(verts).items()}
    got = intersect.intersect_bvh_packed(
        _t(o), _t(d), tab, active=None if active is None else _t(active),
        t_max=None if t_max is None else _t(t_max))
    _assert_hits(got, want, "gather walk vs jax")


# ---- BVH2 packer ------------------------------------------------------------
# The kernel's walk itself runs only on the card (tests/test_torch_cuda.py);
# here the tables it walks are held to the invariants it relies on.

def _bvh2_verts(case):
    if case == "soup":
        return _soup(np.random.default_rng(4), 900)
    if case == "sphere":
        v, f = icosphere(3)
        return (v[f] * 3.0).astype(np.float32)
    v, f = utah_teapot(n=4)
    return v[f].astype(np.float32)


def _bvh2(verts):
    tab = _bvh_tables(verts)
    return tab, traverse_bvh2.pack_bvh2(tab["node_packed"], tab["leaf_packed"])


def decode_nodes(nodes):
    """The inverse of ``traverse_bvh2.node_records``: (box_a, box_b [I, 6] min(3) max(3),
    references [I, 2] int32)."""
    nodes = np.asarray(nodes, dtype=np.float32)
    return (nodes[:, [0, 2, 8, 1, 3, 9]], nodes[:, [4, 6, 10, 5, 7, 11]],
            nodes.view(np.int32)[:, 12:14])


def decode_bvh2(p, leaf_packed):
    """The BVH2 kernel's node records in the JAX packer's layout: nodebox
    [I, 12] (both children's min(3) max(3)) and childs [I, 2] (>= 0 inner,
    -(leaf id + 1) a leaf), each leaf reference ~(first << LEAF_BITS |
    count) mapped back to the gather-walk leaf whose real slots are rows
    first .. first + count - 1."""
    box_a, box_b, refs = decode_nodes(p["nodes"])
    first, count = traverse_bvh2.leaf_spans(leaf_packed)
    code = (first << traverse_bvh2.LEAF_BITS) | count
    leaf_of = {int(c): leaf for leaf, c in enumerate(code)}
    assert len(leaf_of) == len(code) and (count > 0).all()
    childs = np.array([[r if r >= 0 else -(leaf_of[~int(r)] + 1)
                        for r in pair] for pair in refs], dtype=np.int64)
    return np.concatenate([box_a, box_b], axis=1), childs


def _subtree_rows(p, ref):
    """Rows of the BVH2 triangle table under a child reference."""
    if ref < 0:
        code = ~int(ref)
        first = code >> traverse_bvh2.LEAF_BITS
        return p["tris"][first:first + (code & ((1 << traverse_bvh2.LEAF_BITS)
                                                - 1))]
    refs = decode_nodes(p["nodes"])[2]
    return np.concatenate([_subtree_rows(p, c) for c in refs[ref]])


@pytest.mark.parametrize("case", ["soup", "sphere", "teapot"])
def test_bvh2_tables_reach_every_triangle_once(case):
    verts = _bvh2_verts(case)
    _, p = _bvh2(verts)
    refs = decode_nodes(p["nodes"])[2]
    seen_inner, seen_leaves, level = {0}, [], [0]
    while level:
        nxt = refs[level].ravel()
        seen_leaves += [~int(c) for c in nxt if c < 0]
        level = [int(c) for c in nxt if c >= 0]
        seen_inner.update(level)
    assert seen_inner == set(range(len(refs)))
    covered = np.zeros(len(p["tris"]), np.int64)
    for code in seen_leaves:
        first = code >> traverse_bvh2.LEAF_BITS
        covered[first:first + (code & ((1 << traverse_bvh2.LEAF_BITS) - 1))] += 1
    assert (covered == 1).all()
    tri = p["tris"][:, 3]
    assert sorted(tri.astype(int).tolist()) == list(range(len(verts)))


@pytest.mark.parametrize("case", ["soup", "sphere", "teapot"])
def test_bvh2_child_boxes_bound_their_subtrees(case):
    """Each node record's two boxes hold every vertex under that child, and
    the triangle rows hold the soup's own v0, e1, e2: the kernel prunes by
    the boxes and tests the rows."""
    verts = _bvh2_verts(case)
    _, p = _bvh2(verts)
    box_a, box_b, refs = decode_nodes(p["nodes"])
    for j, pair in enumerate(refs):
        for side, ref in enumerate(pair):
            box = (box_a, box_b)[side][j]
            rows = _subtree_rows(p, ref)
            v = verts[rows[:, 3].astype(int)].reshape(-1, 3)
            assert (v >= box[:3]).all() and (v <= box[3:]).all(), (j, side)
    rows = p["tris"]
    tri = verts[rows[:, 3].astype(int)]
    np.testing.assert_array_equal(rows[:, 0:3], tri[:, 0])
    np.testing.assert_array_equal(rows[:, 4:7], tri[:, 1] - tri[:, 0])
    np.testing.assert_array_equal(rows[:, 8:11], tri[:, 2] - tri[:, 0])


def test_bvh2_wrapper_takes_the_gather_walk_on_the_cpu():
    verts = _bvh2_verts("soup")
    tab, p = _bvh2(verts)
    scene = dict(bvh={k: _t(v) for k, v in tab.items()},
                 bvh2={k: _t(v) for k, v in p.items()})
    rng = np.random.default_rng(5)
    o, d = _rays(rng, 1000)
    active, t_max = _caps(rng, 1000)
    args = dict(active=_t(active), t_max=_t(t_max))
    calls = intersect.intersect_bvh_packed.calls
    launches = traverse_bvh2.intersect_bvh2.launches
    got = traverse_bvh2.intersect_bvh2(_t(o), _t(d), scene, any_hit=True,
                                       **args)
    want = intersect.intersect_bvh_packed(_t(o), _t(d), scene["bvh"], **args)
    _assert_hits(got, want, "bvh2 on the cpu")
    assert intersect.intersect_bvh_packed.calls == calls + 2
    assert traverse_bvh2.intersect_bvh2.launches == launches


def test_bvh2_depth_bound_enforced(monkeypatch):
    rng = np.random.default_rng(7)
    tab = _bvh_tables(_soup(rng, 500))
    traverse_bvh2.pack_bvh2(tab["node_packed"], tab["leaf_packed"])
    monkeypatch.setattr(traverse_bvh2, "STACK_SIZE", 3)
    with pytest.raises(ValueError, match="exceeds the BVH2 kernel's stack"):
        traverse_bvh2.pack_bvh2(tab["node_packed"], tab["leaf_packed"])


# ---- the dispatch on a BVH scene (sensor plane merged) ----------------------

def test_intersect_scene_bvh_matches_jax():
    v, f = icosphere(2)
    extra = (v[f] * 1.5 + np.array([0.0, 1.0, 0.0])).astype(np.float32)
    kw = dict(pixel_width=16, pixel_height=16, cam_center=[0, 1.5, 6],
              cam_direction=[0, 0, -1.0])
    js = c2.create_scene(extra_geometry=JaxSoup.from_vertices(extra), **kw)
    ts = ct.create_scene(extra_geometry=TriangleSoup.from_vertices(extra),
                         device="cpu", **kw)
    assert "camtri" in ts.data and "brute" not in ts.data
    rng = np.random.default_rng(8)
    o, d = _rays(rng, 1200, spread=6.0)
    # rays aimed back at the sensor exercise the camera-triangle merge
    o[:200] = rng.uniform(-1, 1, (200, 3)) + np.float32([0, 1.5, 3])
    d[:200] = np.float32([0, 0, 1])
    active, _ = _caps(rng, 1200)
    want = jax_isect.intersect_scene(jnp.asarray(o), jnp.asarray(d), js.data,
                                     active=jnp.asarray(active))
    got = intersect.intersect_scene(_t(o), _t(d), ts.data, active=_t(active))
    _assert_hits(got, want, "intersect_scene")
    assert (np.asarray(got[0]) >= 0).sum() > 600
    assert np.isin(np.asarray(got[0])[:200], ts.camera_tri_ids).any()


def test_kernel_wrappers_refuse_other_devices():
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        brute.intersect_brute(o, o, torch.zeros(2, 10, device="meta"))
