"""The BVH2 kernel's tables and tie rule (ops/traverse_bvh2.py) on the CPU.

* the kernel's 64-byte node records decode bit for bit to the
  ``nodebox``/``childs`` of the JAX package's own ``pack_bvh2`` (the layout
  of the first design), and its 48-byte triangle rows are the gather walk's
  leaf rows slot for slot, each leaf's (first, count) covering its real
  slots once and no padding slot;
* the rows are 16-byte multiples, the depth bound and the 2^24 id bound
  are enforced, and the constants match the CUDA sources;
* the gather walk (the kernel's plain version) returns the id at the lower
  slot on every exact tie, and a walk over the kernel's own tables with the
  kernel's (t, slot) rule, in numpy f32 with the kernel's expression order,
  returns the gather walk's ids whatever the child order;
* the wrapper checks its tables and takes the gather walk for CPU tensors.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.bvh.build import leaf_tables as jax_leaf_tables
from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_pallas2 as jax_tp2
from clive2_tpu_torch.ops import intersect, traverse_bvh2 as tb
from clive2_tpu_torch.testing import ULP_TIE_RAY, teapots_scene
from test_torch_intersect import (_assert_hits, _bvh2_verts, _bvh_tables,
                                  _caps, _rays, _t, decode_bvh2)
from test_torch_stream2 import _jax_tree
from test_torch_wide import _aimed_rays, tie_case

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(__file__), "..", "clive2_tpu_torch",
                    "csrc")
CASES = ["soup", "sphere", "teapot"]


def _pack(rows):
    return tb.pack_bvh2(rows["node_packed"], rows["leaf_packed"])


def _child_refs(p):
    return p["nodes"].view(np.int32)[:, 12:14]


def _decode_leaf(ref):
    code = ~int(ref)
    return code >> tb.LEAF_BITS, code & ((1 << tb.LEAF_BITS) - 1)


# ---- the kernel's tables -----------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_node_records_decode_to_the_first_design(case):
    """The 64-byte records decode to the JAX package's ``pack_bvh2``
    ``nodebox`` and ``childs`` (the first design's layout) bit for bit, on
    the JAX package's own tree of the same soup."""
    soup, bvh, rows = _jax_tree(_bvh2_verts(case))
    want = jax_tp2.pack_bvh2(bvh, soup, leaf=jax_leaf_tables(bvh, soup))
    p = _pack(rows)
    nodes = p["nodes"]
    n_inner = len(want["childs"]) // 2
    assert nodes.dtype == np.float32 and nodes.shape == (n_inner, 16)
    assert not nodes[:, 14:16].any()
    nodebox, childs = decode_bvh2(p, rows["leaf_packed"])
    np.testing.assert_array_equal(nodebox.ravel().view(np.int32),
                                  want["nodebox"].view(np.int32))
    np.testing.assert_array_equal(childs.ravel(), want["childs"])
    first, count = tb.leaf_spans(rows["leaf_packed"])
    refs = _child_refs(p)
    leaf = -(childs[childs < 0] + 1)
    np.testing.assert_array_equal(
        refs[childs < 0], ~((first[leaf] << tb.LEAF_BITS) | count[leaf]))
    decoded = np.array([_decode_leaf(r) for r in refs[childs < 0]])
    np.testing.assert_array_equal(decoded, np.stack([first[leaf],
                                                     count[leaf]], 1))


def _tie_rows():
    return tie_case(70)[0]


@pytest.mark.parametrize("case", CASES + ["ties"])
def test_triangle_rows_are_the_leaf_rows_slot_for_slot(case):
    rows = _tie_rows() if case == "ties" else _bvh_tables(_bvh2_verts(case))
    p = _pack(rows)
    leaves = rows["leaf_packed"].reshape(-1, tb.LEAF_SLOTS, 10)
    first, count = tb.leaf_spans(rows["leaf_packed"])
    tris = p["tris"]
    assert tris.dtype == np.float32 and tris.shape == (count.sum(), 12)
    covered = np.zeros(len(tris), np.int64)
    for leaf, (f, c) in enumerate(zip(first, count)):
        real = np.nonzero(leaves[leaf, :, 9] >= 0)[0]
        assert len(real) == c > 0
        got = tris[f:f + c]
        want = leaves[leaf, real]
        np.testing.assert_array_equal(got[:, 0:3], want[:, 0:3])
        np.testing.assert_array_equal(got[:, 3], want[:, 9])
        np.testing.assert_array_equal(got[:, 4:7], want[:, 3:6])
        np.testing.assert_array_equal(got[:, 8:11], want[:, 6:9])
        assert not got[:, [7, 11]].any()
        covered[f:f + c] += 1
    assert (covered == 1).all()
    assert (tris[:, 3] >= 0).all()              # no padding slot has a row


def test_spans_skip_padding_anywhere_in_a_leaf():
    """Padding slots in the middle of a leaf get no row, and the rows keep
    slot order, so row order is slot order for the tie rule."""
    rows = dict(_bvh_tables(_bvh2_verts("soup")))
    leaves = rows["leaf_packed"].reshape(-1, tb.LEAF_SLOTS, 10).copy()
    full = np.nonzero((leaves[:, :, 9] >= 0).all(1))[0][:3]
    assert len(full) == 3
    leaves[full[0], 2, 9] = -1
    leaves[full[1], [0, 5], 9] = -1
    rows["leaf_packed"] = leaves.reshape(len(leaves), -1)
    p = _pack(rows)
    first, count = tb.leaf_spans(rows["leaf_packed"])
    assert list(count[full]) == [7, 6, 8]
    for leaf in full:
        real = leaves[leaf, leaves[leaf, :, 9] >= 0]
        np.testing.assert_array_equal(
            p["tris"][first[leaf]:first[leaf] + count[leaf], 3], real[:, 9])
    slot = np.nonzero(leaves[:, :, 9].ravel() >= 0)[0]
    assert (np.diff(slot) > 0).all() and len(slot) == len(p["tris"])


def test_rows_are_16_byte_multiples():
    p = _pack(_bvh_tables(_bvh2_verts("teapot")))
    for k, width in (("nodes", 64), ("tris", 48)):
        t = _t(p[k])
        assert t.is_contiguous() and t.stride(0) * t.element_size() == width
        assert width % 16 == 0


def _constant(source, name):
    with open(os.path.join(CSRC, source)) as f:
        for line in f:
            if line.strip().startswith(f"constexpr int {name} ="):
                return int(line.split("=")[1].split(";")[0])
    raise AssertionError(f"{name} not in {source}")


def test_depth_bound_enforced_and_constants_match_the_kernels(monkeypatch):
    assert _constant("common.cuh", "kWalkStack") == tb.STACK_SIZE
    assert _constant("traverse_bvh2.cu", "kLeafBits") == tb.LEAF_BITS
    assert tb.LEAF_SLOTS < 1 << tb.LEAF_BITS
    rows = _bvh_tables(_bvh2_verts("soup"))
    _pack(rows)
    monkeypatch.setattr(tb, "STACK_SIZE", 4)
    with pytest.raises(ValueError, match="exceeds the BVH2 kernel's stack"):
        _pack(rows)


def test_ids_from_2_24_raise():
    rows = dict(_bvh_tables(_bvh2_verts("soup")))
    leaf = rows["leaf_packed"].copy()
    _pack(dict(rows, leaf_packed=leaf))
    leaf[3, 9] = 2.0 ** 24
    with pytest.raises(ValueError, match="below 2\\^24"):
        _pack(dict(rows, leaf_packed=leaf))


# ---- the tie rule and a walk over the kernel's tables ------------------------

def test_gather_walk_takes_the_lower_slot_on_ties():
    """The plain version the kernel is held to: on every exact tie the id
    at the lower slot, as the JAX package's gather walk."""
    rows, o, d, check = tie_case(71)
    got = intersect.intersect_bvh_packed(
        _t(o), _t(d), {k: _t(v) for k, v in rows.items()})
    check(got[0].numpy())
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in rows.items()})
    _assert_hits(got, want, "gather walk on ties")


def _cull(bt):
    """csrc/common.cuh:cull_bound in f32 numpy scalars."""
    return np.float32(bt) * np.float32(intersect.CULL_SLACK)


def _box_entry(lo, hi, o, inv, bt):
    """csrc/common.cuh:box_entry in f32 numpy scalars."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
               max(min(t0[2], t1[2]), np.float32(0)))
    tmax = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])),
               min(max(t0[2], t1[2]), _cull(bt)))
    return tmin if tmin <= tmax else np.float32(np.inf)


def _table_walk(p, o, d, t_max, any_hit, near_first):
    """One ray through the kernel's tables (``nodes``, ``tris``) as the
    kernel walks them: slab tests of both children, the nearer (or the
    left) first, popped entries skipped when past the best t, and each
    leaf's rows tested with the (t, row) rule."""
    nodes, refs, tris = p["nodes"], _child_refs(p), p["tris"]
    tiny = np.float32(1e-30)
    inv = np.float32(1) / np.where(np.abs(d) < tiny,
                                   np.where(d < 0, -tiny, tiny), d)
    bt, bs, bi, bu, bv = np.float32(t_max), -1, -1, 0.0, 0.0
    stack, ref = [], 0
    while True:
        if ref >= 0:
            n = nodes[ref]
            ta = _box_entry(n[[0, 2, 8]], n[[1, 3, 9]], o, inv, bt)
            tb_ = _box_entry(n[[4, 6, 10]], n[[5, 7, 11]], o, inv, bt)
            ca, cb = refs[ref]
            if ta < np.inf and tb_ < np.inf:
                a_first = not near_first or ta <= tb_
                stack.append((cb, tb_) if a_first else (ca, ta))
                ref = ca if a_first else cb
                continue
            if ta < np.inf or tb_ < np.inf:
                ref = ca if ta < np.inf else cb
                continue
        else:
            first, count = _decode_leaf(ref)
            r = tris[first:first + count]
            hit, t, u, v = intersect._mt(
                tuple(o), tuple(d), r[:, 0:3].T, r[:, 4:7].T, r[:, 8:11].T)
            for k in range(count):
                if hit[k] and (t[k] < bt or (t[k] == bt and first + k < bs)):
                    bt, bs, bi = t[k], first + k, int(r[k, 3])
                    bu, bv = u[k], v[k]
            if any_hit and bs >= 0:
                break
        while stack:
            ref, t_entry = stack.pop()
            if t_entry <= _cull(bt):
                break
        else:
            break
    return bi, bt if bs >= 0 else np.float32(np.inf), bu, bv


def _walk_all(p, o, d, t_max, any_hit=False, near_first=True):
    out = [_table_walk(p, o[i], d[i], t_max[i], any_hit, near_first)
           for i in range(len(o))]
    return tuple(np.array(c, dtype=np.int32 if j == 0 else np.float32)
                 for j, c in enumerate(zip(*out)))


@pytest.mark.parametrize("mode", ["closest", "capped", "any_hit"])
def test_table_walk_matches_the_gather_walk(mode):
    rng = np.random.default_rng(72 + ["closest", "capped",
                                      "any_hit"].index(mode))
    rows = _bvh_tables(_bvh2_verts("soup"))
    p = _pack(rows)
    o, d = _aimed_rays(rng, 300)
    t_max = (np.full(300, np.inf, np.float32) if mode == "closest"
             else _caps(rng, 300)[1])
    want = intersect.intersect_bvh_packed(
        _t(o), _t(d), {k: _t(v) for k, v in rows.items()}, t_max=_t(t_max))
    hit = want[0].numpy() >= 0
    assert hit.sum() > 60
    for near_first in (True, False):
        got = _walk_all(p, o, d, t_max, mode == "any_hit", near_first)
        _assert_hits(got, want, f"{mode} near_first={near_first}",
                     closest=mode != "any_hit")
        if mode == "any_hit":
            assert (got[1][hit] < t_max[hit]).all()


def test_table_walk_takes_the_lower_slot_on_ties():
    rows, o, d, check = tie_case(73)
    p = _pack(rows)
    n = 400
    inf = np.full(n, np.inf, np.float32)
    want = intersect.intersect_bvh_packed(
        _t(o[:n]), _t(d[:n]), {k: _t(v) for k, v in rows.items()})
    assert (want[0] >= 0).sum() > 50
    for near_first in (True, False):
        got = _walk_all(p, o[:n], d[:n], inf, near_first=near_first)
        _assert_hits(got, want, f"ties near_first={near_first}")


def test_a_tie_an_ulp_past_its_box_is_still_tested(tmp_path):
    """Triangles 1439 and 1549 of the teapots scene share an edge that the
    ray hits: the same t from both.  1549's leaf has the lower slot, but
    its box's slab entry rounds an ulp past that t, so a walk that tests
    1439's leaf first (the nearer box) culled 1549's at the best t, and the
    persistent-warp kernel answered 1439 or 1549 by its schedule (found on
    the card in a Morton-order sample's reference-estimator connection
    cast).  Culled past ``cull_bound``, the kernel's walk takes the lower
    slot in either child order, as the gather walk does."""
    scene = teapots_scene(tmp_path, 512, 512, "cpu")
    rows = {k: v.numpy() for k, v in scene.data["bvh"].items()}
    bits = lambda x: np.asarray(x, np.int32).view(np.float32)
    o, d = bits(ULP_TIE_RAY["o"])[None], bits(ULP_TIE_RAY["d"])[None]
    t_max = bits([ULP_TIE_RAY["t_max"]])
    want = intersect.intersect_bvh_packed(_t(o), _t(d), scene.data["bvh"],
                                          t_max=_t(t_max))
    assert int(want[0]) == ULP_TIE_RAY["want"]
    # both triangles hit at the same t, and the winner's leaf box enters
    # past it
    leaf = rows["leaf_packed"].reshape(len(rows["leaf_packed"]), -1, 10)
    inv = intersect.safe_inverse(_t(d))
    for tri in ULP_TIE_RAY["tied"]:
        ell, k = (int(x[0]) for x in np.nonzero(leaf[:, :, 9] == tri))
        hit, t, _, _ = intersect.moller_trumbore(
            _t(o), _t(d), *(_t(leaf[ell, k, c:c + 3])[None]
                            for c in (0, 3, 6)))
        assert bool(hit[0]) and float(t[0]) == float(want[1][0])
        if tri == ULP_TIE_RAY["want"]:
            node = rows["node_packed"][rows["node_packed"][:, 7] == ell][0]
            entry = intersect.box_entry(_t(o), inv, _t(node[0:6])[None],
                                        torch.tensor([np.inf]))
            assert float(t[0]) < float(entry[0]) <= float(
                intersect.cull_bound(t[0]))
    p = _pack(rows)
    for near_first in (True, False):
        got = _walk_all(p, o, d, t_max, near_first=near_first)
        _assert_hits(got, want, f"ulp tie near_first={near_first}")
    # the other traversals that run Möller-Trumbore, each on its own tables
    # (the fat-leaf walk's own arithmetic breaks this tie by t)
    from clive2_tpu_torch import scene as port_scene
    from clive2_tpu_torch.ops import traverse_stream, traverse_wide

    for name, plain in (("wide", traverse_wide.wide_plain),
                        ("stream", traverse_stream.stream_plain)):
        tables = port_scene.to_device(port_scene.traversal_tables(
            rows, 0, cuda=False, traversal=name), "cpu")[name]
        got = plain(_t(o), _t(d), tables, t_max=_t(t_max))
        assert int(got[0][0]) == ULP_TIE_RAY["want"], name


# ---- the wrapper -------------------------------------------------------------

def test_kernel_wrapper_checks_its_tables_and_instance():
    rows = _bvh_tables(_bvh2_verts("soup"))
    tables = {k: _t(v).to("meta") for k, v in _pack(rows).items()}
    bvh = {k: _t(v).to("meta") for k, v in rows.items()}
    o = torch.zeros(4, 3, device="meta")
    bad = dict(nodes=tables["nodes"].reshape(-1, 8),
               tris=tables["tris"].double())
    for k, t in bad.items():
        with pytest.raises(ValueError, match=f"bvh2 table {k}"):
            tb.intersect_bvh2(o, o, {"bvh": bvh, "bvh2": dict(tables,
                                                             **{k: t})})
    with pytest.raises(ValueError, match="no BVH2 tables"):
        tb.intersect_bvh2(o, o, {"bvh": bvh})
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.intersect_bvh2(o, o, {"bvh": bvh, "bvh2": tables})
    assert not hasattr(tb, "INSTANCES")


@pytest.mark.parametrize("case", CASES)
def test_every_instance_takes_the_gather_walk_on_the_cpu(case):
    """The wrapper takes the gather walk for CPU tensors on every case, and
    launches nothing."""
    rows = _bvh_tables(_bvh2_verts(case))
    scene = dict(bvh={k: _t(v) for k, v in rows.items()},
                 bvh2={k: _t(v) for k, v in _pack(rows).items()})
    rng = np.random.default_rng(74 + CASES.index(case))
    o, d = _rays(rng, 500)
    active, t_max = _caps(rng, 500)
    launches = tb.intersect_bvh2.launches
    got = tb.intersect_bvh2(_t(o), _t(d), scene, active=_t(active),
                            t_max=_t(t_max))
    want = intersect.intersect_bvh_packed(_t(o), _t(d), scene["bvh"],
                                          active=_t(active), t_max=_t(t_max))
    _assert_hits(got, want, f"bvh2 {case} on the cpu")
    assert tb.intersect_bvh2.launches == launches
