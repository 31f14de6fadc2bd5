"""The BVH8 traversal (clive2_tpu_torch/ops/traverse_wide.py) against the JAX
package on the CPU.

* ``collapse_bvh8`` from the gather walk's rows equals the JAX collapse of
  the FlatBVH node by node (same children in the same order, same DFS
  numbering), and each wide node's children and boxes equal JAX
  ``pack_bvh8``'s as sets (the JAX packer reorders children to match its
  leaf pages);
* the 256-byte node records decode to the collapse child for child: boxes,
  inner ids, leaf references to ``leaf_spans``, empty children ``EMPTY``
  after the others; the pack-time stack and node-id bounds are enforced and
  the constants match the CUDA source;
* ``wide_plain`` gives 0 differing ids against the JAX gather walk on every
  set, and against the JAX kernel in interpret mode on one masked, capped
  case (JAX's own wide tests require exact ids:
  tests/test_pallas_kernels.py:_assert_hits_equal); any-hit verdicts equal
  the gather walk's;
* a numpy walk of the records in the kernel's schedule (warps of 32 lanes
  that fetch rays from a shared counter, postponed leaf-child masks) equals
  ``wide_plain`` on coherent, incoherent, masked and capped sets, any-hit
  ids included, and takes the lower slot on exact ties;
* on exact ties the lower slot wins, whatever the visit order.

The kernel's own walk runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import intersect as jax_isect
from clive2_tpu.ops import traverse_wide as jax_wide
from clive2_tpu_torch.ops import intersect
from clive2_tpu_torch.ops import traverse_bvh2 as tb
from clive2_tpu_torch.ops import traverse_wide as tw
from clive2_tpu_torch.testing import swap_pair_ids
from test_pallas_kernels import _assert_hits_equal
from test_torch_intersect import _assert_hits, _camera_rays, _rays, _soup, _t
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


def _records(got):
    """(boxes [W, 8, 6], references [W, 8]) of packed node records."""
    return tuple(x.numpy() for x in tw.decode_records(_t(got["nodes"])))


def _children(wbox, wchild, jax_layout=None, tris=None):
    """Per wide node, the set of its children: (box, inner wide id) or
    (box, the leaf's triangle ids); the port's leaves read their triangle
    rows ``tris``."""
    out = []
    for w in range(len(wchild)):
        kids = set()
        for c in range(tw.WIDE):
            box = tuple(wbox[w, c].tolist())
            ch = int(wchild[w, c])
            if jax_layout is None:
                if ch == tw.EMPTY:
                    assert box == (float(np.float32(tw.BIG)),) * 6
                    continue
                code = ~ch
                start = code >> tb.LEAF_BITS
                n = code & ((1 << tb.LEAF_BITS) - 1)
                ids = tris[start:start + n, 3] if ch < 0 else None
            else:
                if box == (float(np.float32(jax_wide.BIG)),) * 6:
                    continue
                base = jax_layout["lblocks"][w] * 128 + c * jax_wide.LEAF_COLS
                ids = jax_layout["leaff"][:, base + 9] if ch < 0 else None
            kids.add((box, ch) if ids is None
                     else (box, tuple(sorted(ids[ids >= 0].tolist()))))
        out.append(kids)
    return out


def test_pack_matches_jax_pack_as_sets():
    """Per wide node, the set of (box, inner child) and (box, the leaf's
    triangle ids) equals the JAX packer's."""
    verts = _soup(np.random.default_rng(51), 1500)
    soup, bvh, rows = _jax_tree(verts)
    want = jax_wide.pack_bvh8(bvh, soup)
    got = tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    boxes, refs = _records(got)
    n_wide = len(refs)
    jbox = want["wideboxes"][:48, :n_wide].reshape(6, 8, n_wide).transpose(
        2, 1, 0)                                       # [wide, child, field]
    jchild = want["childs"].reshape(n_wide, 8)
    theirs = _children(jbox, jchild, jax_layout=want)
    mine = _children(boxes, refs, tris=got["tris"])
    assert mine == theirs
    # every leaf of the binary tree is a child of exactly one wide node
    first, count = tb.leaf_spans(rows["leaf_packed"])
    leaves = ~refs[(refs < 0) & (refs != tw.EMPTY)]
    assert sorted(leaves.tolist()) == sorted(
        ((first << tb.LEAF_BITS) | count).tolist())


@pytest.mark.parametrize("t", [300, 2000])
def test_records_decode_to_the_collapse(t):
    """Child c of wide node w is the collapse's child: its box is the
    binary node's, an inner child is its wide id, a leaf child is
    ~(first << LEAF_BITS | count) of that leaf's ``leaf_spans``, and the
    slots past the children are EMPTY with the +BIG box; records are 256
    bytes with hi.w = 0, and the triangle rows are ``triangle_rows``."""
    rows = _jax_tree(_soup(np.random.default_rng(54 + t), t))[2]
    node_packed = rows["node_packed"]
    got = tw.pack_bvh8(node_packed, rows["leaf_packed"])
    boxes, refs = _records(got)
    kids, wide_of = tw.collapse_bvh8(node_packed)
    first, count = tb.leaf_spans(rows["leaf_packed"])
    assert len(refs) == len(kids) > 4
    n_leaves = 0
    for w, children in enumerate(kids):
        for c in range(tw.WIDE):
            if c >= len(children):
                assert refs[w, c] == tw.EMPTY
                assert (boxes[w, c] == np.float32(tw.BIG)).all()
                continue
            b = children[c]
            np.testing.assert_array_equal(boxes[w, c], node_packed[b, 0:6])
            leaf = int(node_packed[b, 7])
            if leaf < 0:
                assert refs[w, c] == wide_of[b]
                continue
            n_leaves += 1
            code = ~int(refs[w, c])
            assert refs[w, c] < 0 and refs[w, c] != tw.EMPTY
            assert code >> tb.LEAF_BITS == first[leaf]
            assert code & ((1 << tb.LEAF_BITS) - 1) == count[leaf] > 0
    assert n_leaves == len(rows["leaf_packed"])
    rec = got["nodes"].reshape(-1, tw.WIDE, tw.CHILD)
    assert (rec[:, :, 7] == 0).all()
    np.testing.assert_array_equal(got["tris"],
                                  tb.triangle_rows(rows["leaf_packed"]))
    for k, width in (("nodes", 256), ("tris", 48)):
        x = _t(got[k])
        assert x.dtype == torch.float32 and x.is_contiguous()
        assert x.stride(0) * x.element_size() == width


def test_stack_bound_enforced(monkeypatch):
    rows = _jax_tree(_soup(np.random.default_rng(52), 2000))[2]
    need = tw.stack_bound(_records(_tables(rows))[1])
    assert 8 < need <= tw.STACK_SIZE
    monkeypatch.setattr(tw, "STACK_SIZE", need - 1)
    with pytest.raises(ValueError, match=f"may need {need} stack entries"):
        tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    monkeypatch.setattr(tw, "STACK_SIZE", need)
    tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])


def test_constants_and_node_id_bound_match_the_kernel(monkeypatch):
    """The stack depth and leaf bits are the CUDA source's; more wide nodes
    than the kernel's 24-bit node ids raise, and triangle ids from 2^24
    too."""
    from test_torch_bvh2 import _constant

    assert _constant("traverse_wide.cu", "kWideStack") == tw.STACK_SIZE
    assert _constant("traverse_wide.cu", "kLeafBits") == tb.LEAF_BITS
    assert _constant("traverse_wide.cu", "kWide") == tw.WIDE
    rows = dict(_jax_tree(_soup(np.random.default_rng(55), 900))[2])
    n_wide = len(tw.pack_bvh8(rows["node_packed"],
                              rows["leaf_packed"])["nodes"])
    monkeypatch.setattr(tw, "MAX_NODES", n_wide - 1)
    with pytest.raises(ValueError, match="node ids below"):
        tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    monkeypatch.setattr(tw, "MAX_NODES", n_wide)
    leaf = rows["leaf_packed"].copy()
    leaf[3, 9] = 2.0 ** 24
    with pytest.raises(ValueError, match="2\\^24"):
        tw.pack_bvh8(rows["node_packed"], leaf)


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
        _t(o), _t(d), {"wide": _tables(rows)},
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
    got = tw.wide_plain(_t(o), _t(d), _tables(rows), active=_t(active),
                        t_max=_t(t_max))
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
    check(tw.wide_plain(_t(o), _t(d), _tables(rows))[0].numpy())


# ---- a walk of the kernel's records in the kernel's schedule ----------------

class _Lane:
    """One lane of csrc/traverse_wide.cu in numpy f32: its ray, best hit,
    wide node ``ref`` (None: kNone), stack, postponed set ``post`` and the
    second set ``pend``, each (node, hit leaf children in child order)."""

    def __init__(self, rec):
        self.rec, self.has_ray = rec, False

    def start(self, r, o, d, t_max):
        tiny = np.float32(1e-30)
        self.r, self.o, self.d = r, o, d
        self.inv = np.float32(1) / np.where(np.abs(d) < tiny,
                                            np.where(d < 0, -tiny, tiny), d)
        self.bt, self.bs, self.bi = np.float32(t_max), -1, -1
        self.bu = self.bv = np.float32(0)
        self.ref, self.post, self.pend, self.stack = 0, None, None, []
        self.has_ray = True

    def box(self, node, c):
        from test_torch_bvh2 import _box_entry

        box = self.rec["boxes"][node, c]
        return _box_entry(box[0:3], box[3:6], self.o, self.inv, self.bt)

    def pop(self):
        while self.stack:
            ref, t_entry = self.stack.pop()
            if t_entry <= self.bt:
                return ref
        return None

    def visit(self):
        """Slab tests of the children in order (stopping at the first
        empty one), the other hit inner children pushed in child order, on
        to the nearest (the first of equal distances); hit leaf children
        postponed as a set."""
        node, refs = self.ref, self.rec["refs"]
        inner, leaves, best, best_t = [], [], None, np.float32(np.inf)
        for c in range(tw.WIDE):
            if refs[node, c] == tw.EMPTY:
                break
            t = self.box(node, c)
            if not t < np.inf:
                continue
            if refs[node, c] >= 0:
                inner.append((c, t))
                if t < best_t:
                    best, best_t = c, t
            else:
                leaves.append(c)
        self.stack += [(int(refs[node, c]), t) for c, t in inner
                       if c != best]
        if leaves:
            if self.post is None:
                self.post = (node, leaves)
            else:
                self.pend = (node, leaves)
        self.ref = int(refs[node, best]) if best is not None else self.pop()

    def test_sets(self, any_hit):
        """The postponed sets: each leaf child slab-tested again against
        the current best t, then its rows with the (t, row) rule."""
        tris = self.rec["tris"]
        while self.post is not None:
            node, leaves = self.post
            for c in leaves:
                if not self.box(node, c) < np.inf:
                    continue
                code = ~int(self.rec["refs"][node, c])
                first = code >> tb.LEAF_BITS
                count = code & ((1 << tb.LEAF_BITS) - 1)
                r = tris[first:first + count]
                hit, t, u, v = intersect._mt(
                    tuple(self.o), tuple(self.d), r[:, 0:3].T, r[:, 4:7].T,
                    r[:, 8:11].T)
                for k in range(count):
                    if hit[k] and (t[k] < self.bt or (
                            t[k] == self.bt and first + k < self.bs)):
                        self.bt, self.bs = t[k], first + k
                        self.bi, self.bu, self.bv = int(r[k, 3]), u[k], v[k]
            if any_hit and self.bs >= 0:
                self.ref, self.pend = None, None
            self.post, self.pend = self.pend, None


def _kernel_schedule(p, o, d, active, t_max, any_hit, warps=3):
    """The kernel's walk of its records (``nodes``, ``tris``) with its
    schedule: ``warps`` warps of 32 lanes, run in turns, take rays from one
    counter whenever kRefill of their lanes are free (inactive rays are
    written as misses at once), walk wide nodes while any lane of the warp
    still searches for its first set of leaf children (a lane with one set
    walks on until it finds a second), then test the sets, then write the
    finished rays.  Returns (ids, t, u, v)."""
    from test_torch_bvh2 import _constant

    refill = _constant("common.cuh", "kRefill")
    boxes, refs = _records(p)
    rec = dict(boxes=boxes, refs=refs, tris=p["tris"])
    n = len(o)
    out = (np.full(n, -2, np.int32), np.zeros(n, np.float32),
           np.zeros(n, np.float32), np.zeros(n, np.float32))
    nxt = 0
    team = [dict(lanes=[_Lane(rec) for _ in range(32)], drained=False,
                 done=False) for _ in range(warps)]
    while not all(w["done"] for w in team):
        for w in team:
            if w["done"]:
                continue
            lanes = w["lanes"]
            free = [ln for ln in lanes if not ln.has_ray]
            if not w["drained"] and len(free) >= refill:
                base, nxt = nxt, nxt + len(free)
                w["drained"] = nxt >= n
                for r, ln in zip(range(base, nxt), free):
                    if r >= n:
                        break
                    if active[r]:
                        ln.start(r, o[r], d[r], t_max[r])
                    else:
                        for a, x in zip(out, (-1, np.inf, 0, 0)):
                            a[r] = x
            if not any(ln.has_ray for ln in lanes):
                w["done"] = w["drained"]
                continue
            while True:
                for ln in lanes:
                    if ln.has_ray and ln.ref is not None and ln.pend is None:
                        ln.visit()
                if not any(ln.has_ray and ln.ref is not None
                           and ln.post is None for ln in lanes):
                    break
            for ln in lanes:
                if ln.has_ray:
                    ln.test_sets(any_hit)
            for ln in lanes:
                if ln.has_ray and ln.ref is None and ln.post is None:
                    hit = ln.bs >= 0
                    for a, x in zip(out, (ln.bi, ln.bt if hit else np.inf,
                                          ln.bu, ln.bv)):
                        a[ln.r] = x
                    ln.has_ray = False
    assert (out[0] >= -1).all(), "a ray was never written"
    return out


SCHEDULE_SETS = ["coherent", "incoherent", "masked", "capped"]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("rays", SCHEDULE_SETS)
def test_kernel_schedule_matches_plain(rays, any_hit):
    """The kernel's walk in its schedule gives ``wide_plain``'s ids, t, u
    and v (any-hit: its ids, so the stop is at the same node, and the JAX
    gather walk's verdicts), and the JAX gather walk's ids on closest
    rays."""
    rng = np.random.default_rng(100 + SCHEDULE_SETS.index(rays))
    rows = _jax_tree(_soup(rng, 1200))[2]
    n = 256
    o, d = (_camera_rays(rng, n) if rays == "coherent"
            else _aimed_rays(rng, n))
    active = (rng.uniform(size=n) < 0.6 if rays == "masked"
              else np.ones(n, bool))
    t_max = (np.where(rng.uniform(size=n) < 0.3, np.inf,
                      rng.uniform(2.0, 20.0, n)).astype(np.float32)
             if rays == "capped" or any_hit else np.full(n, np.inf,
                                                         np.float32))
    p = tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    plain = tw.wide_plain(_t(o), _t(d), {k: _t(v) for k, v in p.items()},
                          active=_t(active), t_max=_t(t_max),
                          any_hit=any_hit)
    got = _kernel_schedule(p, o, d, active, t_max, any_hit)
    want = jax_isect.intersect_bvh_packed(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in rows.items()},
        active=jnp.asarray(active), t_max=jnp.asarray(t_max))
    assert (np.asarray(want[0]) >= 0).sum() > 40
    _assert_hits(got, plain, f"{rays} vs wide_plain")
    if any_hit:
        np.testing.assert_array_equal(got[0] >= 0, np.asarray(want[0]) >= 0)
        hit = got[0] >= 0
        assert (got[1][hit] < t_max[hit]).all()
    else:
        _assert_hits_equal(got, want, f"{rays} vs the JAX gather walk")


def test_kernel_schedule_takes_the_lower_slot_on_ties():
    rows, o, d, check = tie_case(67)
    o, d = o[:1000], d[:1000]
    p = tw.pack_bvh8(rows["node_packed"], rows["leaf_packed"])
    n = len(o)
    got = _kernel_schedule(p, o, d, np.ones(n, bool),
                           np.full(n, np.inf, np.float32), False)
    check(got[0])
    _assert_hits(got, tw.wide_plain(_t(o), _t(d), {
        k: _t(v) for k, v in p.items()}), "ties vs wide_plain")


def test_kernel_wrapper_checks_its_tables_and_device():
    rows = _jax_tree(_soup(np.random.default_rng(66), 900))[2]
    tables = {k: v.to("meta") for k, v in _tables(rows).items()}
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="table nodes"):
        tw.intersect_wide(o, o, {"wide": dict(
            tables, nodes=tables["nodes"].reshape(-1, 32))})
    with pytest.raises(ValueError, match="table tris"):
        tw.intersect_wide(o, o, {"wide": dict(
            tables, tris=tables["tris"].double())})
    with pytest.raises(ValueError, match="no wide tables"):
        tw.intersect_wide(o, o, {"bvh": {}})
    with pytest.raises(ValueError, match="CUDA tensors"):
        tw.intersect_wide(o, o, {"wide": tables})
