"""The BVH8 traversal (clive2_tpu_torch/ops/traverse_wide.py) against the JAX
package on the CPU.

* ``collapse_bvh8`` from the gather walk's rows equals the JAX collapse of
  the FlatBVH node by node (same children in the same order, same DFS
  numbering), and each wide node's children and boxes equal JAX
  ``pack_bvh8``'s as sets (the JAX packer reorders children to match its
  leaf pages);
* the pack-time stack bound is enforced;
* ``wide_plain`` gives 0 differing ids against the JAX gather walk on every
  set, and against the JAX kernel in interpret mode on one masked, capped
  case (JAX's own wide tests require exact ids:
  tests/test_pallas_kernels.py:_assert_hits_equal); any-hit verdicts equal
  the gather walk's;
* on exact ties the lower slot wins, whatever the visit order.

The kernel's own walk runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_wide as jax_wide
from clive2_tpu_torch.ops import traverse_wide as tw
from clive2_tpu_torch.testing import swap_pair_ids
from test_pallas_kernels import _assert_hits_equal
from test_torch_intersect import _rays, _soup, _t
from test_torch_stream2 import _jax_tree

torch.set_num_threads(2)


def _tables(rows):
    return {k: _t(v) for k, v in tw.pack_bvh8(rows["node_packed"],
                                               rows["leaf_packed"]).items()}


def _aimed_rays(rng, n):
    """Rays from around the soup towards random points inside it."""
    o, _ = _rays(rng, n)
    d = rng.uniform(-5, 5, (n, 3)).astype(np.float32) - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


# ---- collapse and packer -----------------------------------------------------

@pytest.mark.parametrize("t", [300, 2000])
def test_collapse_matches_jax_node_by_node(t):
    _, bvh, rows = _jax_tree(_soup(np.random.default_rng(50 + t), t))
    want, want_of = jax_wide.collapse_bvh8(bvh)
    got, got_of = tw.collapse_bvh8(rows["node_packed"])
    assert len(got) == len(want) > 4
    for w, (mine, theirs) in enumerate(zip(got, want)):
        assert mine == [int(b) for b in theirs], f"wide node {w}"
    assert got_of == {int(b): w for b, w in want_of.items()}


def _children(wbox, wchild, leaf_rows, jax_layout=None):
    """Per wide node, the set of its children: (box, inner wide id) or
    (box, the leaf's triangle ids)."""
    out = []
    for w in range(len(wchild)):
        kids = set()
        for c in range(tw.WIDE):
            box = tuple(wbox[w, c].tolist())
            if jax_layout is None:
                ch = int(wchild[w, c])
                if ch == tw.EMPTY:
                    assert box == (float(np.float32(tw.BIG)),) * 6
                    continue
                tris = leaf_rows[-(ch + 1), :, 9] if ch < 0 else None
            else:
                if box == (float(np.float32(jax_wide.BIG)),) * 6:
                    continue
                ch = int(wchild[w, c])
                base = jax_layout["lblocks"][w] * 128 + c * jax_wide.LEAF_COLS
                tris = jax_layout["leaff"][:, base + 9] if ch < 0 else None
            kids.add((box, ch) if tris is None
                     else (box, tuple(sorted(tris[tris >= 0].tolist()))))
        out.append(kids)
    return out


def test_pack_matches_jax_pack_as_sets():
    verts = _soup(np.random.default_rng(51), 1500)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_wide.pack_bvh8(bvh, soup)
    got = tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    n_wide = len(got["wchild"])
    jbox = want["wideboxes"][:48, :n_wide].reshape(6, 8, n_wide).transpose(
        2, 1, 0)                                       # [wide, child, field]
    jchild = want["childs"].reshape(n_wide, 8)
    theirs = _children(jbox, jchild, None, jax_layout=want)
    mine = _children(got["wbox"], got["wchild"],
                     rows["leaf_packed"].reshape(-1, 8, 10))
    assert mine == theirs
    # every leaf of the binary tree is a child of exactly one wide node
    leaves = got["wchild"][(got["wchild"] < 0) & (got["wchild"] != tw.EMPTY)]
    assert sorted((-(leaves + 1)).tolist()) == list(range(
        len(rows["leaf_packed"])))


def test_stack_bound_enforced(monkeypatch):
    rows = _jax_tree(_soup(np.random.default_rng(52), 2000))[2]
    need = tw.stack_bound(_tables(rows)["wchild"].numpy())
    assert 8 < need <= tw.STACK_SIZE
    monkeypatch.setattr(tw, "STACK_SIZE", need - 1)
    with pytest.raises(ValueError, match=f"may need {need} stack entries"):
        tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    monkeypatch.setattr(tw, "STACK_SIZE", need)
    tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])


def test_a_leaf_root_is_refused():
    rows = _jax_tree(_soup(np.random.default_rng(53), 5))[2]
    with pytest.raises(ValueError, match="inner root"):
        tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])


# ---- wide_plain against the JAX gather walk and the JAX kernel ---------------

CASES = {
    # name: (triangles, rays, masked, capped, any_hit)
    "closest": (1500, 2000, False, False, False),
    "masked": (900, 1500, True, False, False),
    "t_max": (1500, 1500, False, True, False),
    "any_hit": (1500, 2000, True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_gather_walk(case):
    t, n, masked, capped, any_hit = CASES[case]
    rng = np.random.default_rng(60 + list(CASES).index(case))
    rows = _jax_tree(_soup(rng, t))[2]
    o, d = _aimed_rays(rng, n)
    active = rng.uniform(size=n) < 0.6 if masked else None
    t_max = rng.uniform(1.0, 14.0, n).astype(np.float32) if capped else None
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in rows.items()},
        active=None if active is None else jnp.asarray(active),
        t_max=None if t_max is None else jnp.asarray(t_max))
    calls = tw.wide_plain.calls
    got = tw.intersect_wide(
        _t(o), _t(d), {"wide": _tables(rows),
                       "bvh": {k: _t(v) for k, v in rows.items()}},
        active=None if active is None else _t(active),
        t_max=None if t_max is None else _t(t_max), any_hit=any_hit)
    assert tw.wide_plain.calls == calls + 1
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
    """One interpret-mode call of the JAX kernel (about 10 s): masks, caps
    (half of them infinite) and 0 differing ids."""
    rng = np.random.default_rng(64)
    verts = _soup(rng, 700)
    soup, bvh, rows = _jax_tree(verts)
    o, d = _aimed_rays(rng, 600)
    active = rng.uniform(size=600) < 0.7
    t_max = np.where(rng.uniform(size=600) < 0.5, np.inf,
                     rng.uniform(1.0, 12.0, 600)).astype(np.float32)
    packed = {k: jnp.asarray(v) for k, v in
              jax_wide.pack_bvh8(bvh, soup).items()}
    want = jax_wide.intersect_wide(
        jnp.asarray(o), jnp.asarray(d), packed, active=jnp.asarray(active),
        t_max=jnp.asarray(t_max), interpret=True, group_gate=False,
        pop2=False, bits=False)
    got = tw.wide_plain(_t(o), _t(d), _tables(rows),
                        {k: _t(v) for k, v in rows.items()},
                        active=_t(active), t_max=_t(t_max))
    assert (np.asarray(want[0]) >= 0).sum() > 50
    _assert_hits_equal(got, want, "wide vs jax interpret")


def tie_case(seed):
    """Every triangle of a 700-triangle soup twice, with the ids of a random
    half of the pairs swapped in the leaf rows, and rays aimed at the soup:
    each hit is an exact tie in t, and the lower slot (leaf * 8 + k) does
    not always hold the lower id.  Returns (rows, o, d, check), ``check``
    asserting that every hit reports the id at the lower slot of its
    pair."""
    rng = np.random.default_rng(seed)
    base = _soup(rng, 700)
    rows = dict(_jax_tree(np.concatenate([base, base]))[2])
    rows["leaf_packed"], lower = swap_pair_ids(rows["leaf_packed"], 700, rng)
    o, d = _aimed_rays(rng, 1500)

    def check(got):
        hit = got >= 0
        assert hit.sum() > 200
        np.testing.assert_array_equal(got[hit], lower(got[hit]))
        assert (got[hit] >= 700).any() and (got[hit] < 700).any()

    return rows, o, d, check


def test_exact_ties_go_to_the_lower_slot():
    """The walk returns the id at the lower slot on every exact tie,
    however the two copies of a triangle are spread over the tree."""
    rows, o, d, check = tie_case(65)
    check(tw.wide_plain(_t(o), _t(d), _tables(rows),
                        {k: _t(v) for k, v in rows.items()})[0].numpy())


def test_kernel_wrapper_checks_its_tables_and_device():
    rows = _jax_tree(_soup(np.random.default_rng(66), 900))[2]
    tables = {k: v.to("meta") for k, v in _tables(rows).items()}
    bvh = {k: _t(v).to("meta") for k, v in rows.items()}
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="table wbox"):
        tw.intersect_wide(o, o, {"bvh": bvh, "wide": dict(
            tables, wbox=tables["wbox"].reshape(-1, 48))})
    with pytest.raises(ValueError, match="table wchild"):
        tw.intersect_wide(o, o, {"bvh": bvh, "wide": dict(
            tables, wchild=tables["wchild"].long())})
    with pytest.raises(ValueError, match="no wide tables"):
        tw.intersect_wide(o, o, {"bvh": bvh})
    with pytest.raises(ValueError, match="CUDA tensors"):
        tw.intersect_wide(o, o, {"bvh": bvh, "wide": tables})
