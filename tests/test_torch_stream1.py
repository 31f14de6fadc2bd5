"""The streaming traversal (stream1, clive2_tpu_torch/ops/traverse_stream.py)
against the JAX package on the CPU.

* ``pack_stream``'s records (64-byte top nodes, 32-byte sub-leaves, 48-byte
  triangle rows) decode to the JAX packer's cut and top tree; each fat leaf
  holds exactly the JAX fat leaf's SAH leaves with their triangles (rows
  0-9 of its block) and their boxes (rows 10-15), at one and two blocks per
  leaf; they decode to ``top_tree``'s tables and to the gather walk's rows
  slot for slot, and the port's stream2 kernel shares the same top tree;
* the top tree's depth bound, the fat-leaf count bits and the 2^24 id
  bound are enforced, and the constants match the CUDA sources;
* ``stream_plain`` gives 0 differing ids against the JAX gather walk on
  every set, and against the JAX kernel in interpret mode on one masked,
  capped case; any-hit verdicts equal the gather walk's;
* a numpy walk of the records with the kernel's (t, row) rule and its
  postponed fat leaves equals ``stream_plain`` and the JAX gather walk on
  closest, capped and any-hit rays and on exact ties;
* on exact ties the lower slot wins, whatever the visit order.

The kernel's own walk runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_stream as jax_stream
from clive2_tpu_torch.ops import intersect
from clive2_tpu_torch.ops import traverse_stream as ts
from clive2_tpu_torch.ops import traverse_stream2 as s2
from test_pallas_kernels import _assert_hits_equal
from test_torch_bvh2 import _box_entry, _constant, _cull
from test_torch_intersect import _assert_hits, _soup, _t, decode_nodes
from test_torch_stream2 import _jax_tree
from test_torch_wide import _aimed_rays, tie_case

torch.set_num_threads(2)


def _tables(rows, blocks_per_leaf=1):
    return {k: _t(v) for k, v in ts.pack_stream(
        rows["node_packed"], rows["leaf_packed"],
        blocks_per_leaf=blocks_per_leaf).items()}


# ---- packer ------------------------------------------------------------------

def decode_stream(tables):
    """The inverse of ``ts.pack_stream`` above the triangle rows, as the
    kernel reads its records: dict(nodebox [I, 12] (both children's min(3)
    max(3)), childs [I, 2] (>= 0 top node, -(f + 1) fat leaf f, fat leaves
    numbered in record order), fat_start [F + 1] (fat leaf f holds
    ``subs`` rows fat_start[f] .. fat_start[f + 1] - 1), sub_box [S, 6],
    sub_first [S], sub_count [S] (each sub-leaf's triangle rows)).  Raises
    unless the fat leaves' sub-leaf ranges tile ``subs`` in order."""
    box_a, box_b, refs = decode_nodes(np.asarray(tables["nodes"]))
    codes = ~refs[refs < 0].astype(np.int64)
    first, count = codes >> ts.FAT_BITS, codes & ((1 << ts.FAT_BITS) - 1)
    order = np.argsort(first, kind="stable")
    fat_start = np.concatenate([first[order], [first[order][-1]
                                               + count[order][-1]]])
    if not (np.diff(fat_start) == count[order]).all() or fat_start[0]:
        raise ValueError("fat leaves do not tile the sub-leaf records")
    fat_of = np.empty(len(codes), dtype=np.int64)
    fat_of[order] = np.arange(len(codes))
    childs = refs.astype(np.int64)
    childs[refs < 0] = -(fat_of + 1)
    subs = np.asarray(tables["subs"], dtype=np.float32)
    return dict(nodebox=np.concatenate([box_a, box_b], axis=1),
                childs=childs, fat_start=fat_start, sub_box=subs[:, 0:6],
                sub_first=subs.view(np.int32)[:, 6],
                sub_count=subs.view(np.int32)[:, 7])


def _subleaf_ids(got, rows):
    """Per fat leaf of the decoded records, its sub-leaves' triangle ids,
    each a list of the ids of its rows."""
    dec = decode_stream(got)
    tris = got["tris"]
    return dec, [[tris[dec["sub_first"][j]:dec["sub_first"][j]
                       + dec["sub_count"][j], 3].astype(np.int64).tolist()
                  for j in range(dec["fat_start"][f], dec["fat_start"][f + 1])]
                 for f in range(len(dec["fat_start"]) - 1)]


@pytest.mark.parametrize("blocks_per_leaf", [1, 2])
def test_fat_leaves_match_jax_blocks(blocks_per_leaf):
    """Same cut and child encoding as the JAX packer; fat leaf f's SAH
    leaves, in order, carry the triangles of rows 0-9 of the JAX block f
    (slot for slot, padding skipped) and the boxes of its rows 10-15."""
    verts = _soup(np.random.default_rng(70 + blocks_per_leaf), 1500)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_stream.pack_stream(bvh, soup, blocks_per_leaf=blocks_per_leaf)
    got = ts.pack_stream(rows["node_packed"], rows["leaf_packed"],
                         blocks_per_leaf=blocks_per_leaf)
    dec, ids = _subleaf_ids(got, rows)
    np.testing.assert_array_equal(dec["childs"].ravel(), want["childs"])
    blocks = want["leafblocks"]
    n_fat = len(dec["fat_start"]) - 1
    assert blocks.shape[0] == n_fat > 4
    width = ts.SUBTILES * blocks_per_leaf
    for f in range(n_fat):
        k = len(ids[f])
        tri = blocks[f, 9].reshape(width, 8)
        for j in range(k):
            assert ids[f][j] == [int(x) for x in tri[j] if x >= 0]
        assert (tri[k:] == -1).all()
        box = blocks[f, 10:16].reshape(6, width, 8)[:, :k, 0].T   # [k, 6]
        sub = slice(dec["fat_start"][f], dec["fat_start"][f + 1])
        np.testing.assert_array_equal(dec["sub_box"][sub], box)
    # the stream2 kernel walks the same top tree
    mine2 = s2.pack_stream2(rows["node_packed"], rows["leaf_packed"],
                            blocks_per_leaf=blocks_per_leaf)
    np.testing.assert_array_equal(mine2["childs"], dec["childs"])
    np.testing.assert_array_equal(mine2["nodebox"].view(np.int32),
                                  dec["nodebox"].view(np.int32))
    # every SAH leaf sits in one fat leaf, in preorder
    assert (np.diff(dec["sub_first"]) > 0).all()
    assert len(got["subs"]) == len(rows["leaf_packed"])


@pytest.mark.parametrize("blocks_per_leaf", [1, 2])
def test_records_decode_to_the_top_tree_and_rows(blocks_per_leaf):
    """The records decode to ``top_tree``'s nodebox, childs, fat_start and
    sub_node (each sub-leaf's box is its node row's, and its rows are its
    gather-walk leaf's real slots, slot for slot), every triangle row is
    named by exactly one sub-leaf, and the rows are 16-byte multiples."""
    rows = _jax_tree(_soup(np.random.default_rng(75 + blocks_per_leaf),
                           1200))[2]
    got = ts.pack_stream(rows["node_packed"], rows["leaf_packed"],
                         blocks_per_leaf=blocks_per_leaf)
    tree = ts.top_tree(rows["node_packed"], ts.SUBTILES * blocks_per_leaf,
                       ts.STACK_SIZE)
    dec = decode_stream(got)
    np.testing.assert_array_equal(dec["nodebox"].view(np.int32),
                                  tree["nodebox"].view(np.int32))
    np.testing.assert_array_equal(dec["childs"], tree["childs"])
    per_fat = np.bincount(tree["fat_ids"], minlength=tree["n_fat"])
    np.testing.assert_array_equal(dec["fat_start"],
                                  np.concatenate([[0], np.cumsum(per_fat)]))
    sub_node = tree["leaf_nodes"]
    np.testing.assert_array_equal(dec["sub_box"],
                                  rows["node_packed"][sub_node, 0:6])
    leaves = rows["leaf_packed"].reshape(-1, 8, 10)
    covered = np.zeros(len(got["tris"]), np.int64)
    for j, node in enumerate(sub_node):
        leaf = leaves[int(rows["node_packed"][node, 7])]
        real = leaf[leaf[:, 9] >= 0]
        f, c = dec["sub_first"][j], dec["sub_count"][j]
        r = got["tris"][f:f + c]
        assert c == len(real) > 0
        np.testing.assert_array_equal(r[:, 0:3], real[:, 0:3])
        np.testing.assert_array_equal(r[:, 3], real[:, 9])
        np.testing.assert_array_equal(r[:, 4:7], real[:, 3:6])
        np.testing.assert_array_equal(r[:, 8:11], real[:, 6:9])
        covered[f:f + c] += 1
    assert (covered == 1).all()
    for k, width in (("nodes", 64), ("subs", 32), ("tris", 48)):
        t = _t(got[k])
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.stride(0) * t.element_size() == width and width % 16 == 0


def test_constants_and_bounds_match_the_kernel(monkeypatch):
    """The record constants are the CUDA sources'; fat leaves past the
    count bits and triangle ids from 2^24 raise."""
    assert _constant("traverse_stream.cu", "kFatBits") == ts.FAT_BITS
    assert _constant("common.cuh", "kWalkStack") == ts.STACK_SIZE
    assert ts.SUBTILES < 1 << ts.FAT_BITS
    rows = dict(_jax_tree(_soup(np.random.default_rng(77), 900))[2])
    ts.pack_stream(rows["node_packed"], rows["leaf_packed"])
    with pytest.raises(ValueError, match="count bits"):
        ts.pack_stream(rows["node_packed"], rows["leaf_packed"],
                       blocks_per_leaf=4)
    leaf = rows["leaf_packed"].copy()
    leaf[3, 9] = 2.0 ** 24
    with pytest.raises(ValueError, match="2\\^24"):
        ts.pack_stream(rows["node_packed"], leaf)


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
    got = ts.stream_plain(_t(o), _t(d), _tables(rows), active=_t(active),
                          t_max=_t(t_max))
    assert (np.asarray(want[0]) >= 0).sum() > 50
    _assert_hits_equal(got, want, "stream vs jax interpret")


def test_exact_ties_go_to_the_lower_slot():
    """The walk returns the id at the lower slot on every exact tie,
    whichever fat leaf it visits first (test_torch_wide.tie_case)."""
    rows, o, d, check = tie_case(91)
    check(ts.stream_plain(_t(o), _t(d), _tables(rows))[0].numpy())


# ---- a walk of the kernel's records ------------------------------------------

def _record_walk(p, o, d, t_max, any_hit, eager):
    """One ray through the kernel's records (``nodes``, ``subs``,
    ``tris``) as a lane of the kernel walks them, in numpy f32: slab tests
    of both children, the nearer first, the farther pushed; a fat leaf is
    postponed and, with ``eager``, the walk goes on until it finds a second
    one (the most a lane walks ahead while its warp searches), else it is
    scanned at once; popped entries are skipped when past the best t; each
    sub-leaf's box against the current best t, then its rows with the
    (t, row) rule; any-hit stops after the first fat leaf with a hit."""
    box_a, box_b, refs = decode_nodes(p["nodes"])
    subs, tris = p["subs"], p["tris"]
    sub_first, sub_count = (subs.view(np.int32)[:, 6],
                            subs.view(np.int32)[:, 7])
    tiny = np.float32(1e-30)
    inv = np.float32(1) / np.where(np.abs(d) < tiny,
                                   np.where(d < 0, -tiny, tiny), d)
    bt, bs, bi, bu, bv = np.float32(t_max), -1, -1, 0.0, 0.0
    stack = []

    def pop():
        while stack:
            r, t_entry = stack.pop()
            if t_entry <= _cull(bt):
                return r
        return None

    def walk(ref, fat):
        """Walk from ``ref`` until a fat leaf is found (returned with the
        next ref) or the stack runs out."""
        while ref is not None and ref >= 0:
            ta = _box_entry(box_a[ref, :3], box_a[ref, 3:], o, inv, bt)
            tb_ = _box_entry(box_b[ref, :3], box_b[ref, 3:], o, inv, bt)
            ca, cb = (int(x) for x in refs[ref])
            if ta < np.inf and tb_ < np.inf:
                a_first = ta <= tb_
                stack.append((cb, tb_) if a_first else (ca, ta))
                ref = ca if a_first else cb
            elif ta < np.inf or tb_ < np.inf:
                ref = ca if ta < np.inf else cb
            else:
                ref = pop()
            if ref is not None and ref < 0 and fat is None:
                fat, ref = ref, pop()
                if not eager:
                    break
        return ref, fat

    ref, fat = walk(0, None)
    while fat is not None:
        code = ~fat
        first_sub, n_sub = code >> ts.FAT_BITS, code & ((1 << ts.FAT_BITS) - 1)
        for j in range(first_sub, first_sub + n_sub):
            if not _box_entry(subs[j, 0:3], subs[j, 3:6], o, inv,
                              bt) < np.inf:
                continue
            f, c = int(sub_first[j]), int(sub_count[j])
            r = tris[f:f + c]
            hit, t, u, v = intersect._mt(
                tuple(o), tuple(d), r[:, 0:3].T, r[:, 4:7].T, r[:, 8:11].T)
            for k in range(c):
                if hit[k] and (t[k] < bt or (t[k] == bt and f + k < bs)):
                    bt, bs, bi = t[k], f + k, int(r[k, 3])
                    bu, bv = u[k], v[k]
        if any_hit and bs >= 0:
            break
        if ref is not None and ref < 0:
            fat, ref = ref, pop()
        else:
            fat = None
        if fat is None and ref is not None:
            ref, fat = walk(ref, None)
        elif eager and ref is not None:
            ref, _ = walk(ref, fat)
    return bi, bt if bs >= 0 else np.float32(np.inf), bu, bv


@pytest.mark.parametrize("mode", ["closest", "capped", "any_hit", "ties"])
def test_record_walk_matches_plain_and_jax(mode):
    """The kernel's walk of its records, eager or not, gives
    ``stream_plain``'s ids, t, u and v (any-hit: its ids too, and the JAX
    gather walk's verdicts), the JAX gather walk's ids on closest and capped
    rays, and the lower slot on every exact tie."""
    rng = np.random.default_rng(95 + ["closest", "capped", "any_hit",
                                      "ties"].index(mode))
    if mode == "ties":
        rows, o, d, check = tie_case(96)
        o, d = o[:900], d[:900]
    else:
        rows = _jax_tree(_soup(rng, 1200))[2]
        o, d = _aimed_rays(rng, 300)
    n = len(o)
    t_max = (rng.uniform(1.0, 12.0, n).astype(np.float32)
             if mode in ("capped", "any_hit") else np.full(n, np.inf,
                                                           np.float32))
    p = ts.pack_stream(rows["node_packed"], rows["leaf_packed"])
    any_hit = mode == "any_hit"
    plain = ts.stream_plain(_t(o), _t(d), {k: _t(v) for k, v in p.items()},
                            t_max=_t(t_max), any_hit=any_hit)
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in rows.items()}, t_max=jnp.asarray(t_max))
    assert (np.asarray(want[0]) >= 0).sum() > 50
    _assert_hits_equal(plain, want, mode) if not any_hit else \
        np.testing.assert_array_equal(plain[0].numpy() >= 0,
                                      np.asarray(want[0]) >= 0)
    for eager in (False, True):
        out = [_record_walk(p, o[i], d[i], t_max[i], any_hit, eager)
               for i in range(n)]
        got = tuple(np.array(c, dtype=np.int32 if j == 0 else np.float32)
                    for j, c in enumerate(zip(*out)))
        _assert_hits(got, plain, f"{mode} eager={eager}")
        if mode == "ties":
            check(got[0])


def test_kernel_wrapper_checks_its_tables_and_device():
    rows = _jax_tree(_soup(np.random.default_rng(92), 900))[2]
    tables = {k: v.to("meta") for k, v in _tables(rows).items()}
    bvh = {k: _t(v).to("meta") for k, v in rows.items()}
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="table subs"):
        ts.intersect_stream(o, o, {"bvh": bvh, "stream": dict(
            tables, subs=tables["subs"].double())})
    with pytest.raises(ValueError, match="table tris"):
        ts.intersect_stream(o, o, {"bvh": bvh, "stream": dict(
            tables, tris=tables["tris"][:, :10])})
    with pytest.raises(ValueError, match="no stream tables"):
        ts.intersect_stream(o, o, {"bvh": bvh})
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.intersect_stream(o, o, {"bvh": bvh, "stream": tables})
