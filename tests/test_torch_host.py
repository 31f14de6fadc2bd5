"""The port's host layer builds the JAX package's scene arrays bit for bit:
triangle attributes, BVH nodes and leaf tables, materials, lights, camera
basis, the sensor-plane triangles and the brute table; ``convert`` maps a
JAX scene onto the same tensors; and the BVH2 kernel tables, derived from
the gather walk's rows, equal the JAX package's own ``pack_bvh2`` records.
"""

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.models import icosphere
from clive2_tpu.ops import traverse_pallas2 as jax_tp2
from clive2_tpu_torch.convert import scene_data_from_jax
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from clive2_tpu_torch.ops.traverse_bvh2 import pack_bvh2
from test_torch_intersect import decode_bvh2

torch.set_num_threads(2)


def _kwargs(name):
    if name == "cornell":
        return dict(pixel_width=24, pixel_height=24,
                    cam_center=[0, 1.5, 6], cam_direction=[0, 0, -1]), None
    sub, scale, offset, mat = {"icosphere2": (2, 1.5, [0.0, 1.0, 0.0], 4),
                               "glass": (1, 1.6, [0.0, 0.6, 1.0], 5)}[name]
    v, f = icosphere(sub)
    verts = (v[f] * scale + np.array(offset)).astype(np.float32)
    return dict(pixel_width=24, pixel_height=16, cam_center=[0, 1.5, 6],
                cam_direction=[0, 0, -1.0]), (verts, mat)


def _scenes(name):
    kw, extra = _kwargs(name)
    if extra is None:
        return c2.create_scene(**kw), ct.create_scene(device="cpu", **kw)
    verts, mat = extra
    return (c2.create_scene(extra_geometry=JaxSoup.from_vertices(
                verts, material=mat), **kw),
            ct.create_scene(extra_geometry=TorchSoup.from_vertices(
                verts, material=mat), device="cpu", **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(jax_tree, torch_tree, path=""):
    assert set(jax_tree) == set(torch_tree), path
    for k, want in jax_tree.items():
        got = torch_tree[k]
        if isinstance(want, dict):
            _assert_same(want, got, f"{path}{k}.")
            continue
        got = got.numpy()
        assert got.dtype == want.dtype, f"{path}{k}: {got.dtype} {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{path}{k}")


@pytest.mark.parametrize("name", ["cornell", "icosphere2", "glass"])
def test_scene_arrays_bit_equal(name):
    js, ts = _scenes(name)
    jd, td = _np(js.data), ts.data
    for k in ("tri", "mat", "lights", "camera", "bvh"):
        _assert_same(jd[k], td[k], f"{k}.")
    assert (js.n_triangles, js.n_nodes) == (ts.n_triangles, ts.n_nodes)
    np.testing.assert_array_equal(js.camera_tri_ids, ts.camera_tri_ids)
    if "brute" in jd:
        t = ts.n_triangles
        tris = td["brute"]["tris"].numpy()
        for col, key in ((0, "v0"), (3, "e1"), (6, "e2")):
            np.testing.assert_array_equal(tris[:, col:col + 3],
                                          jd["brute"][key][:t])
        assert not jd["brute"]["v0"][t:].any()       # JAX pads with zeros
        assert "camtri" not in td
    else:
        _assert_same(jd["camtri"], td["camtri"], "camtri.")
        assert "bvh2" not in td            # kernel tables only on CUDA


@pytest.mark.parametrize("name", ["cornell", "icosphere2", "glass"])
def test_scene_data_from_jax_matches_create_scene(name):
    js, ts = _scenes(name)
    converted = scene_data_from_jax(_np(js.data), device="cpu")
    _assert_same({k: _np(v) if isinstance(v, dict) else np.asarray(v)
                  for k, v in jax.tree.map(lambda t: t.numpy(),
                                           ts.data).items()},
                 converted)


@pytest.mark.parametrize("name", ["icosphere2", "glass_bvh"])
def test_bvh2_tables_equal_the_jax_packer(name):
    if name == "glass_bvh":
        v, f = icosphere(3)
        world = JaxSoup.from_vertices((v[f] * 2.0).astype(np.float32))
    else:
        v, f = icosphere(2)
        world = JaxSoup.from_vertices((v[f] * 1.5).astype(np.float32))
    from clive2_tpu.bvh.build import build_bvh, leaf_tables
    from clive2_tpu.ops.intersect import pack_gather_walk

    bvh = build_bvh(world)
    leafs = leaf_tables(bvh, world)
    want = jax_tp2.pack_bvh2(bvh, world, leaf=leafs)
    rows = pack_gather_walk(bvh, leafs)
    got = pack_bvh2(rows["node_packed"], rows["leaf_packed"])
    nodebox, childs = decode_bvh2(got, rows["leaf_packed"])
    np.testing.assert_array_equal(nodebox.ravel(), want["nodebox"])
    np.testing.assert_array_equal(childs.ravel(), want["childs"])
    # JAX's leaf table is tri-major [8 slots, 16 * L]; our rows are its
    # real slots (tri id >= 0) in slot order, as v0 id e1 0 e2 0
    n_leaves = rows["leaf_packed"].shape[0]
    jl = want["leaff"][:, :16 * n_leaves].reshape(8, n_leaves, 16)
    jl = jl.transpose(1, 0, 2).reshape(-1, 16)
    jl = jl[jl[:, 9] >= 0]
    tris = got["tris"]
    np.testing.assert_array_equal(tris[:, [0, 1, 2, 4, 5, 6, 8, 9, 10, 3]],
                                  jl[:, :10])


def test_host_modules_import_no_jax():
    import clive2_tpu_torch.camera as cam
    import clive2_tpu_torch.geometry as geo

    for mod in (cam, geo):
        assert "jax" not in mod.__dict__
    soup = TorchSoup.from_vertices(np.eye(3, dtype=np.float32)[None])
    ref = JaxSoup.from_vertices(np.eye(3, dtype=np.float32)[None])
    np.testing.assert_array_equal(soup.face_normals, ref.face_normals)
