"""The streaming traversal (stream1, clive2_tpu_torch/ops/traverse_stream.py)
against the JAX package on the CPU.

* ``pack_stream`` from the gather walk's rows makes the JAX packer's cut
  and top tree, each fat leaf holds exactly the JAX fat leaf's SAH leaves
  with their triangles (rows 0-9 of its block) and their boxes (rows
  10-15), at one and two blocks per leaf, and the port's stream2 kernel
  shares the same top tree;
* the top tree's depth bound is enforced;
* ``stream_plain`` gives 0 differing ids against the JAX gather walk on
  every set, and against the JAX kernel in interpret mode on one masked,
  capped case; any-hit verdicts equal the gather walk's;
* on exact ties the lower slot wins, whatever the visit order.

The kernel's own walk runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_stream as jax_stream
from clive2_tpu_torch.ops import traverse_stream as ts
from clive2_tpu_torch.ops import traverse_stream2 as s2
from test_pallas_kernels import _assert_hits_equal
from test_torch_intersect import _soup, _t
from test_torch_stream2 import _jax_tree
from test_torch_wide import _aimed_rays, tie_case

torch.set_num_threads(2)


def _tables(rows, blocks_per_leaf=1):
    return {k: _t(v) for k, v in ts.pack_stream(
        rows["node_packed"], rows["leaf_packed"],
        blocks_per_leaf=blocks_per_leaf).items()}


# ---- packer ------------------------------------------------------------------

@pytest.mark.parametrize("blocks_per_leaf", [1, 2])
def test_fat_leaves_match_jax_blocks(blocks_per_leaf):
    """Same cut and child encoding as the JAX packer; fat leaf f's SAH
    leaves, in order, carry the triangles of rows 0-9 of the JAX block f
    (slot for slot, padding included) and the boxes of its rows 10-15."""
    verts = _soup(np.random.default_rng(70 + blocks_per_leaf), 1500)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_stream.pack_stream(bvh, soup, blocks_per_leaf=blocks_per_leaf)
    got = ts.pack_stream(rows["node_packed"], rows["leaf_packed"],
                         blocks_per_leaf=blocks_per_leaf)
    np.testing.assert_array_equal(got["childs"].ravel(), want["childs"])
    blocks = want["leafblocks"]
    n_fat = len(got["fat_start"]) - 1
    assert blocks.shape[0] == n_fat > 4
    width = ts.SUBTILES * blocks_per_leaf
    leaves = rows["leaf_packed"].reshape(-1, 8, 10)
    for f in range(n_fat):
        nodes = got["sub_node"][got["fat_start"][f]:got["fat_start"][f + 1]]
        k = len(nodes)
        tri = blocks[f, 9].reshape(width, 8)
        lid = rows["node_packed"][nodes, 7].astype(np.int64)
        np.testing.assert_array_equal(leaves[lid, :, 9], tri[:k])
        assert (tri[k:] == -1).all()
        box = blocks[f, 10:16].reshape(6, width, 8)[:, :k, 0].T   # [k, 6]
        np.testing.assert_array_equal(rows["node_packed"][nodes, 0:6], box)
    # the stream2 kernel walks the same top tree
    mine2 = s2.pack_stream2(rows["node_packed"], rows["leaf_packed"],
                            blocks_per_leaf=blocks_per_leaf)
    np.testing.assert_array_equal(mine2["childs"], got["childs"])
    np.testing.assert_array_equal(mine2["nodebox"], got["nodebox"])
    # every SAH leaf sits in one fat leaf, in preorder
    assert (np.diff(got["sub_node"]) > 0).all()
    assert len(got["sub_node"]) == len(rows["leaf_packed"])


def test_top_tree_depth_bound_enforced(monkeypatch):
    rows = _jax_tree(_soup(np.random.default_rng(73), 900))[2]
    ts.pack_stream(rows["node_packed"], rows["leaf_packed"])
    monkeypatch.setattr(ts, "STACK_SIZE", 2)
    with pytest.raises(ValueError, match="exceeds the fat-leaf kernel's"):
        ts.pack_stream(rows["node_packed"], rows["leaf_packed"])


def test_too_small_a_scene_is_refused():
    rows = _jax_tree(_soup(np.random.default_rng(74), 60))[2]
    with pytest.raises(ValueError, match="too small"):
        ts.pack_stream(rows["node_packed"], rows["leaf_packed"])


# ---- stream_plain against the JAX gather walk and the JAX kernel -------------

CASES = {
    # name: (triangles, rays, blocks_per_leaf, masked, capped, any_hit)
    "closest": (1500, 2000, 1, False, False, False),
    "masked": (900, 1500, 1, True, False, False),
    "t_max": (1500, 1500, 1, False, True, False),
    "any_hit": (1500, 2000, 1, True, True, True),
    "two_blocks": (2000, 1500, 2, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_gather_walk(case):
    t, n, bpl, masked, capped, any_hit = CASES[case]
    rng = np.random.default_rng(80 + list(CASES).index(case))
    rows = _jax_tree(_soup(rng, t))[2]
    o, d = _aimed_rays(rng, n)
    active = rng.uniform(size=n) < 0.6 if masked else None
    t_max = rng.uniform(1.0, 14.0, n).astype(np.float32) if capped else None
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in rows.items()},
        active=None if active is None else jnp.asarray(active),
        t_max=None if t_max is None else jnp.asarray(t_max))
    calls = ts.stream_plain.calls
    got = ts.intersect_stream(
        _t(o), _t(d), {"stream": _tables(rows, bpl),
                       "bvh": {k: _t(v) for k, v in rows.items()}},
        active=None if active is None else _t(active),
        t_max=None if t_max is None else _t(t_max), any_hit=any_hit)
    assert ts.stream_plain.calls == calls + 1
    hit = np.asarray(want[0]) >= 0
    assert hit.sum() > n // 10
    if active is not None:
        assert (got[0].numpy()[~active] == -1).all()
    if any_hit:
        np.testing.assert_array_equal(got[0].numpy() >= 0, hit)
        assert (got[1].numpy()[hit] < t_max[hit]).all()
        return
    _assert_hits_equal(got, want, case)


def test_plain_matches_jax_kernel_masked_and_capped():
    """One interpret-mode call of the JAX kernel (about 25 s with its
    default v3 drain): masks, caps (half of them infinite) and 0 differing
    ids."""
    rng = np.random.default_rng(90)
    verts = _soup(rng, 600)
    soup, bvh, rows = _jax_tree(verts)
    o, d = _aimed_rays(rng, 500)
    active = rng.uniform(size=500) < 0.7
    t_max = np.where(rng.uniform(size=500) < 0.5, np.inf,
                     rng.uniform(1.0, 12.0, 500)).astype(np.float32)
    packed = {k: jnp.asarray(v) for k, v in
              jax_stream.pack_stream(bvh, soup).items()}
    want = jax_stream.intersect_stream(
        jnp.asarray(o), jnp.asarray(d), packed, active=jnp.asarray(active),
        t_max=jnp.asarray(t_max), interpret=True)
    got = ts.stream_plain(_t(o), _t(d), _tables(rows),
                          {k: _t(v) for k, v in rows.items()},
                          active=_t(active), t_max=_t(t_max))
    assert (np.asarray(want[0]) >= 0).sum() > 50
    _assert_hits_equal(got, want, "stream vs jax interpret")


def test_exact_ties_go_to_the_lower_slot():
    """The walk returns the id at the lower slot on every exact tie,
    whichever fat leaf it visits first (test_torch_wide.tie_case)."""
    rows, o, d, check = tie_case(91)
    check(ts.stream_plain(_t(o), _t(d), _tables(rows),
                          {k: _t(v) for k, v in rows.items()})[0].numpy())


def test_kernel_wrapper_checks_its_tables_and_device():
    rows = _jax_tree(_soup(np.random.default_rng(92), 900))[2]
    tables = {k: v.to("meta") for k, v in _tables(rows).items()}
    bvh = {k: _t(v).to("meta") for k, v in rows.items()}
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="table sub_node"):
        ts.intersect_stream(o, o, {"bvh": bvh, "stream": dict(
            tables, sub_node=tables["sub_node"].long())})
    with pytest.raises(ValueError, match="table node_packed"):
        ts.intersect_stream(o, o, {"stream": tables, "bvh": dict(
            bvh, node_packed=bvh["node_packed"][:, :6])})
    with pytest.raises(ValueError, match="no stream tables"):
        ts.intersect_stream(o, o, {"bvh": bvh})
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.intersect_stream(o, o, {"bvh": bvh, "stream": tables})
