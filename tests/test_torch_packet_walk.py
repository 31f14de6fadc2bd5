"""The packet walk (ops/packet_walk.py) and the two tools built on it
(clive2_tpu_torch/scripts/kernel_stats.py, kernel_microbench.py) against
the JAX package's tools in scripts/, run as written in interpret mode.

Two facts of the reference shape these tests (the scripts are imported and
never edited):

* The scripts no longer run on the JAX package's tables:
  ``traverse_pallas2.BLOCK_RAYS`` became 16 rows of 128 (2,048 rays) while
  the scripts lay a packet out as 8 x 128, and ``pack_bvh2`` writes a
  triangle-major leaf table [8, 16 L] while the scripts read an
  attribute-major one [16 attributes, 8 L].  ``test_reference_scripts_fail_
  on_the_current_tables`` holds both faults.  To run them, a test sets
  ``kernel_stats.BLOCK_RAYS = 1024`` in its own process (monkeypatch) and
  builds the attribute-major table itself from ``leaf_tables``
  (``_jax_packed``).
* XLA:CPU contracts the Möller-Trumbore multiply-adds of the interpreted
  kernels into FMAs, which the port (separate multiplies and adds, as its
  kernel with ``--fmad=false``) does not, so the t of a hit drifts by a few
  ulps.  On this file's 200-triangle soup it moves t on 60 of the 104
  hits of ``soup200``'s rays by at most 6 ulps (4.4e-7 relative; the
  largest on rays 1141, 1963, 388, 598 and 1672), the same in each
  full-result variant, flipping no id, no count and no box test (a slab
  test is a subtraction and a multiplication, which do not contract).  So against the scripts the ids
  and counts are held equal and t within ``T_RTOL`` = 1e-6 relative on
  hits (exactly on misses); the port's own arithmetic is held bit for bit
  by the gather walk (``test_full_result_variants_match_the_gather_walk``).

The kernel itself runs only on the card (chip_smoke.py, phases
``packet_stats`` and ``packet_ablation``).
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clive2_tpu.bvh.build import leaf_tables as jax_leaf_tables
from clive2_tpu.ops import traverse_pallas2 as jax_tp2
from clive2_tpu_torch.ops import intersect, packet_walk as pw
from clive2_tpu_torch.ops import traverse_bvh2 as tb
from clive2_tpu_torch.scripts import kernel_microbench, kernel_stats
from clive2_tpu_torch.testing import (PACKET_EDGE_RAYS, deep_bvh2_tables,
                                      leaf_tie_winner, packet_edge_rays,
                                      teapots_scene, tie_soup)
from test_torch_intersect import _soup, decode_bvh2
from test_torch_stream2 import _jax_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
import kernel_microbench as jax_microbench  # noqa: E402
import kernel_stats as jax_stats  # noqa: E402

torch.set_num_threads(2)

INF = float("inf")
T_RTOL = 1e-6       # t of a hit against XLA:CPU's contracted arithmetic
FULL_RESULT = ("full", "nogroupskip", "noorder", "noreduce")


def _jax_packed(rows_and_tree):
    """The scripts' tables of the JAX package's tree: ``pack_bvh2``'s
    nodebox, childs, lo and hi, and the attribute-major leaf table the
    scripts read, [16, 8 L padded to 128 columns], leaf l's slot k in
    column 8 l + k (padding columns: tri id -1)."""
    soup, bvh, _ = rows_and_tree
    lt = jax_leaf_tables(bvh, soup)
    packed = jax_tp2.pack_bvh2(bvh, soup, leaf=lt)
    n_leaves, slots = lt["v0"].shape[:2]
    attrs = np.zeros((n_leaves * slots, 16), np.float32)
    attrs[:, 0:3] = lt["v0"].reshape(-1, 3)
    attrs[:, 3:6] = lt["e1"].reshape(-1, 3)
    attrs[:, 6:9] = lt["e2"].reshape(-1, 3)
    attrs[:, 9] = lt["tri_index"].reshape(-1)
    cols = -(-len(attrs) // 128) * 128
    leaff = np.zeros((16, cols), np.float32)
    leaff[9] = -1.0
    leaff[:, :len(attrs)] = attrs.T
    return dict(packed, leaff=leaff)


def _port_tables(rows):
    tables = tb.pack_bvh2(rows["node_packed"], rows["leaf_packed"])
    lo, hi = rows["node_packed"][0, 0:3], rows["node_packed"][0, 3:6]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            dict(tables, lo=lo, hi=hi).items()}


def _cast(seed, n):
    """Rays from around the soup, most aimed into it, a tenth turned away,
    15% inactive and half capped (float32, numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    aim = rng.uniform(-5, 5, (n, 3)).astype(np.float32) - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    away = rng.uniform(size=n) < 0.1
    d[away] = -d[away]
    active = rng.uniform(size=n) < 0.85
    t_max = np.where(rng.uniform(size=n) < 0.5, INF,
                     rng.uniform(2, 14, n)).astype(np.float32)
    return dict(origin=o, direction=d, active=active, t_max=t_max)


def _torch(cast):
    return {k: torch.from_numpy(v) for k, v in cast.items()}


@pytest.fixture(scope="module")
def soup200():
    """A 200-triangle soup: the JAX tree, the scripts' tables, the port's
    tables and 2,000 rays (two packets of 1,024, the second padded)."""
    tree = _jax_tree(_soup(np.random.default_rng(5), 200))
    return dict(tree=tree, jax=_jax_packed(tree), port=_port_tables(tree[2]),
                cast=_cast(6, 2000))


def _planes(cast):
    """The rays in the microbench's 8 x 128 planes (kernel_microbench.py:
    main), padded as it pads."""
    n = len(cast["origin"])
    n_pad = -(-n // 1024) * 1024

    def plane(x, fill):
        flat = np.full(n_pad, fill, np.float32)
        flat[:n] = x
        return jnp.asarray(flat.reshape(n_pad // 128, 128))

    o, d = cast["origin"], cast["direction"]
    return n_pad // 1024, dict(
        ox=plane(o[:, 0], 0.0), oy=plane(o[:, 1], 0.0),
        oz=plane(o[:, 2], 0.0), dx=plane(d[:, 0], 1.0),
        dy=plane(d[:, 1], 0.0), dz=plane(d[:, 2], 0.0),
        act=plane(cast["active"].astype(np.float32), 0.0),
        tm=plane(cast["t_max"], 0.0))


# ---- tables -----------------------------------------------------------------

@pytest.mark.parametrize("t", [41, 200, 600])
def test_tables_carried_across(t):
    """The port's BVH2 records decode to the JAX ``pack_bvh2``'s nodebox and
    childs node for node, and each leaf reference's (first, count) names the
    triangles of the JAX leaf id, in slot order: the walk reads the same
    tree as the scripts."""
    tree = _jax_tree(_soup(np.random.default_rng(70 + t), t))
    want = _jax_packed(tree)
    rows = tree[2]
    nodebox, childs = decode_bvh2(
        tb.pack_bvh2(rows["node_packed"], rows["leaf_packed"]),
        rows["leaf_packed"])
    np.testing.assert_array_equal(nodebox.ravel().view(np.int32),
                                  want["nodebox"].view(np.int32))
    np.testing.assert_array_equal(childs.ravel(), want["childs"])
    tris = tb.pack_bvh2(rows["node_packed"], rows["leaf_packed"])["tris"]
    first, count = tb.leaf_spans(rows["leaf_packed"])
    tri_index = jax_leaf_tables(tree[1], tree[0])["tri_index"]
    for leaf in -(childs[childs < 0] + 1):
        ids = tris[first[leaf]:first[leaf] + count[leaf], 3]
        np.testing.assert_array_equal(
            ids, tri_index[leaf][tri_index[leaf] >= 0])


def test_kernel_constants_and_instances_match_the_module():
    """csrc/packet_walk.cu's stack, leaf rows and leaf code are the
    module's and the packer's, and its instance table lists the variants
    in ``VARIANTS`` order with their leaf phase and push order."""
    path = os.path.join(os.path.dirname(__file__), "..", "clive2_tpu_torch",
                        "csrc", "packet_walk.cu")
    with open(path) as f:
        src = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert constant("kStack") == pw.STACK
    assert constant("kLeafRows") == tb.LEAF_SLOTS
    assert constant("kLeafBits") == tb.LEAF_BITS
    leaf = dict(kSkip="skip", kAlways="always", kNoLeaf="none")
    order = dict(kNear="tmin", kFixed="fixed", kAnyHit="any")
    rows = re.findall(r"\{launch<kPacket, kGroup, (\w+), (\w+), false>", src)
    assert [(leaf[a], order[b]) for a, b in rows] == list(
        pw.VARIANTS.values())
    assert pw.SIZES == ((1024, 128), (32, 32))
    assert "instance<1024, 128>" in src and "instance<32, 32>" in src
    # the bit minima (test_entry_bit_minima_match_amin): no entry is
    # +inf's bits, an entry's bits have the sign cleared
    no_entry = re.search(r"constexpr unsigned kNoEntry = (0x[0-9a-f]+)u;",
                         src)[1]
    assert int(no_entry, 16) == int(np.float32(INF).view(np.uint32))
    assert "__float_as_uint(entry) & 0x7fffffffu : kNoEntry" in src


# ---- the identities the kernel's reductions rest on -------------------------

SPECIAL = np.array([-0.0, 0.0, 1e-45, 3e-42, 1.1754942e-38, 1.1754944e-38,
                    0.5, 0.5, 1.0, 3.4e38, INF], np.float32)


def _entries(seed):
    """Entry distances of 16 packets of 1,024 rays for children A and B
    [16, 2, 1,024] as packet_box gives them (>= 0, -0.0 included, ties,
    subnormals, +inf), and which rays hit each box."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 20, (16, 2, 1024)).astype(np.float32)
    pick = rng.uniform(size=x.shape) < 0.3
    x[pick] = rng.choice(SPECIAL, int(pick.sum()))
    x[0] = INF                          # no entry anywhere
    x[1] = -0.0                         # only -0.0
    x[2, 0], x[2, 1] = -0.0, 0.0        # -0.0 against +0.0
    x[3] = rng.choice(SPECIAL[:4], (2, 1024))   # zeros and subnormals
    x[4, 1] = x[4, 0]                   # A and B tie
    x[5, :, :512] = -0.0                # ±0 in one packet
    hit = rng.uniform(size=x.shape) < 0.8
    hit[6] = False
    return x, hit


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_entry_bit_minima_match_amin(seed):
    """The kernel's minimum of the entry distances (csrc/packet_walk.cu's
    note): on each hit ray the distance's int32 bits with the sign cleared,
    +inf's bits where the box is not hit, the least over each warp's 32
    lanes and then over the 32 warps' minima, is torch.amin of the plain
    version's distances (packet_walk_plain: inf where not hit) with its
    sign cleared, and ``a <= b`` and ``< inf`` on those bits give the
    plain version's verdicts on its float minima."""
    x, hit = _entries(seed)
    dist = torch.where(torch.from_numpy(hit), torch.from_numpy(x), INF)
    bits = torch.where(torch.from_numpy(hit),
                       torch.from_numpy(x).view(torch.int32) & 0x7FFFFFFF,
                       int(np.float32(INF).view(np.int32)))
    least = bits.view(16, 2, 32, 32).amin(3).amin(2)           # [16, 2]
    want = dist.amin(2)
    assert torch.equal(least.view(torch.float32), want)
    assert torch.equal(least, want.view(torch.int32) & 0x7FFFFFFF)
    inf_bits = int(np.float32(INF).view(np.int32))
    assert torch.equal(least < inf_bits, want < INF)
    assert torch.equal(least[:, 0] <= least[:, 1], want[:, 0] <= want[:, 1])
    # the cases are there: no entry, a least -0.0 (read as +0.0 by the
    # bits), a tie of A and B
    assert (want == INF).any() and torch.signbit(want[1]).all()
    assert not torch.signbit(least[1].view(torch.float32)).any()
    assert want[4, 0] == want[4, 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_groups_tested_are_the_ballots_nibbles(seed):
    """The groups a leaf visit tests at 1,024-ray packets: bit w of the
    warps' ballot (warp w hit the leaf box), OR-folded within each nibble
    (a group of 128 rays is 4 warps) and counted, is the plain version's
    count of groups with some hit (``gate.sum``)."""
    rng = np.random.default_rng(seed)
    for p in (0.0, 0.002, 0.02, 0.3, 1.0):
        hit = torch.from_numpy(rng.uniform(size=(64, 1024)) < p)
        want = hit.view(64, 8, 128).any(2).sum(1)
        warp = hit.view(64, 32, 32).any(2).long()
        ballot = (warp << torch.arange(32)).sum(1)
        folded = ballot | (ballot >> 1)
        folded = folded | (folded >> 2)
        got = torch.tensor([bin(int(m) & 0x11111111).count("1")
                            for m in folded])
        assert torch.equal(got, want)


# ---- against the scripts ----------------------------------------------------

@pytest.mark.parametrize("sort", [False, True])
def test_counting_walk_matches_kernel_stats(soup200, monkeypatch, sort):
    """The plain counting walk (``noreduce``, P = 1,024, G = 128) against
    ``scripts/kernel_stats.py:packet_stats``: node pops, leaf visits and
    activations equal on every packet, unsorted and Morton-sorted (the
    port sorting with ``morton_key`` and ``ray_order``)."""
    monkeypatch.setattr(jax_stats, "BLOCK_RAYS", 1024)
    cast = soup200["cast"]
    with pltpu.force_tpu_interpret_mode():
        want, n_blocks = jax_stats.packet_stats(
            *(jnp.asarray(cast[k]) for k in ("origin", "direction")),
            soup200["jax"], active=jnp.asarray(cast["active"]),
            t_max=jnp.asarray(cast["t_max"]), sort=sort)
    got, n_packets = kernel_stats.packet_stats(
        **_torch(cast), tables=soup200["port"], sort=sort)
    assert n_packets == n_blocks == 2
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 1] > 0).all() and (got[:, 2] > got[:, 1]).all()


@pytest.mark.parametrize("variant", list(pw.VARIANTS))
def test_variant_matches_kernel_microbench(soup200, variant):
    """Each variant's plain walk against ``scripts/kernel_microbench.py:
    run_variant`` on the rays in its 8 x 128 planes: ids equal on every
    ray, t equal on every ray without a hit and within T_RTOL on hits (the
    module's note)."""
    cast = soup200["cast"]
    n_blocks, planes = _planes(cast)
    packed = soup200["jax"]
    with pltpu.force_tpu_interpret_mode():
        jt, ji = jax_microbench.run_variant(
            packed["nodebox"], packed["childs"], packed["leaff"], planes,
            n_blocks, *jax_microbench.VARIANTS[variant])
    n = len(cast["origin"])
    jt, ji = np.asarray(jt).ravel()[:n], np.asarray(ji).ravel()[:n]
    t, ids = pw.packet_walk(**_torch(cast), tables=soup200["port"],
                            variant=variant)
    t, ids = t.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, ji)
    hit = ji >= 0
    np.testing.assert_array_equal(t[~hit], jt[~hit])
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=0)
    if variant == "noleaf":
        assert not hit.any()
        np.testing.assert_array_equal(t, cast["t_max"])
    else:
        assert hit.sum() > 50


# ---- against the gather walk and across packet sizes ------------------------

def _brute_ties(cast, rows):
    """Rays whose least hit t is shared by two triangles (brute force over
    the gather walk's leaf rows)."""
    flat = rows["leaf_packed"].reshape(-1, 10)
    flat = torch.from_numpy(flat[flat[:, 9] >= 0])
    c = _torch(cast)
    hit, t, _, _ = intersect.moller_trumbore(
        c["origin"][:, None], c["direction"][:, None], flat[None, :, 0:3],
        flat[None, :, 3:6], flat[None, :, 6:9])
    t = torch.where(hit & (t < c["t_max"][:, None]), t, INF)
    tmin = t.amin(1, keepdim=True)
    return ((t == tmin) & (tmin < INF)).sum(1) > 1


@pytest.mark.parametrize("variant", FULL_RESULT)
def test_full_result_variants_match_the_gather_walk(soup200, variant):
    """The four full-result variants against the port's gather walk
    (``intersect_bvh_packed``): t equal bit for bit on every ray (t_max
    where nothing is hit) and ids equal on every ray, the rays having no
    exact tie (checked by brute force)."""
    cast, rows = soup200["cast"], soup200["tree"][2]
    assert not _brute_ties(cast, rows).any()
    c = _torch(cast)
    want_i, want_t, _, _ = intersect.intersect_bvh_packed(
        c["origin"], c["direction"], {k: torch.from_numpy(v)
                                      for k, v in rows.items()},
        active=c["active"], t_max=c["t_max"])
    for packet, group in pw.SIZES:
        t, ids = pw.packet_walk(**c, tables=soup200["port"], packet=packet,
                                group=group, variant=variant)
        assert torch.equal(ids, want_i), (variant, packet)
        assert torch.equal(t, torch.where(want_i >= 0, want_t,
                                          c["t_max"])), (variant, packet)


@pytest.mark.parametrize("variant", list(pw.VARIANTS))
def test_packet_sizes_agree(soup200, variant):
    """P = 32 (one warp) against P = 1,024: the same t and ids; the counts
    obey their invariants: at least one leaf visit in every packet with an
    active hit, activations at most visits x P/G (equal under
    nogroupskip), at least one pop per packet."""
    c = _torch(soup200["cast"])
    out = {}
    for packet, group in pw.SIZES:
        t, ids, stats = pw.packet_walk(**c, tables=soup200["port"],
                                       packet=packet, group=group,
                                       variant=variant, count=True)
        stats = stats.numpy().astype(np.int64)
        hits = np.pad(ids.numpy() >= 0, (0, len(stats) * packet - len(ids)))
        hit_packets = hits.reshape(len(stats), packet).any(1)
        assert (stats[:, 0] >= 1).all()
        assert (stats[hit_packets, 1] >= 1).all()
        per_visit = stats[:, 1] * (packet // group)
        if variant == "nogroupskip":
            np.testing.assert_array_equal(stats[:, 2], per_visit)
        else:
            assert (stats[:, 2] <= per_visit).all()
        if variant == "noleaf":
            assert not stats[:, 1:].any()
        out[packet] = t, ids
    assert torch.equal(out[32][0], out[1024][0])
    assert torch.equal(out[32][1], out[1024][1])


@pytest.mark.parametrize("kind", [*PACKET_EDGE_RAYS, "deep"])
def test_edge_case_rays_agree_across_packet_sizes(soup200, kind):
    """The rays of the kernel's edge cases (``testing.packet_edge_rays``;
    ``deep``: random rays on ``deep_bvh2_tables``, whose walk holds 47
    stack entries), in every variant: P = 32 and P = 1,024 give the same t
    and ids, and the edge each kind is built for occurs in the plain
    version's own arithmetic (``_slab`` over every node): entries of +0.0
    and -0.0 (faces), hits whose entry is +inf (far), one active warp a
    group (one_warp), every node popped (deep)."""
    depth = 48
    if kind == "deep":
        tables = {k: torch.from_numpy(v)
                  for k, v in deep_bvh2_tables(depth, 31).items()}
        c = _torch(_cast(32, 2048))
        c["origin"] = c["origin"].clamp(-9, 9)
    else:
        tables = soup200["port"]
        c = dict(zip(("origin", "direction", "active", "t_max"),
                     map(torch.from_numpy, packet_edge_rays(
                         tables["nodes"].numpy(), kind, 2048, 33))))
    nodes = tables["nodes"]
    lo = nodes[:, [0, 2, 8, 4, 6, 10]].view(-1, 2, 3)
    hi = nodes[:, [1, 3, 9, 5, 7, 11]].view(-1, 2, 3)
    every = len(nodes)
    hit, near = pw._slab(lo, hi, c["origin"].expand(every, -1, -1),
                         pw.safe_inverse(c["direction"]).expand(every, -1, -1),
                         c["t_max"].expand(every, -1),
                         c["active"].expand(every, -1))
    zero = hit & (near == 0)
    if kind == "faces":
        assert (zero & torch.signbit(near)).any()
        assert (zero & ~torch.signbit(near)).any()
    if kind == "far":
        assert (hit & (near == INF)).any()
    if kind == "one_warp":
        warps = c["active"].view(-1, 4, 32).any(2)
        assert (warps.sum(1) == 1).all()
    for variant in pw.VARIANTS:
        out = {}
        for packet, group in pw.SIZES:
            t, ids, stats = pw.packet_walk(**c, tables=tables, packet=packet,
                                           group=group, variant=variant,
                                           count=True)
            out[packet] = t, ids
            if kind == "deep":
                assert (stats[:, 0] == 2 * depth - 1).all()
        assert torch.equal(out[32][0], out[1024][0]), (kind, variant)
        assert torch.equal(out[32][1], out[1024][1]), (kind, variant)
        if variant != "noleaf":
            assert (out[32][1] >= 0).any()


def test_largest_id_wins_a_tie_inside_a_leaf():
    """The tie soup (``testing.tie_soup``: every triangle twice, ids swapped
    in half the pairs): where both copies of the hit pair share a leaf, the
    walk reports the larger id (kernel_microbench.py:118-121), in every
    variant and at both packet sizes.  (A pair spanning two leaves, rare
    since its copies share a centroid, goes to the leaf visited first.)"""
    rows, _ = tie_soup(11, 150)
    tables = _port_tables(rows)
    rng = np.random.default_rng(12)
    o = rng.uniform(-8, 8, (1500, 3)).astype(np.float32)
    aim = rng.uniform(-5, 5, (1500, 3)).astype(np.float32) - o
    d = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    for variant in FULL_RESULT:
        for packet, group in pw.SIZES:
            _, ids = pw.packet_walk(torch.from_numpy(o), torch.from_numpy(d),
                                    tables, packet=packet, group=group,
                                    variant=variant)
            ids = ids.numpy()
            want = leaf_tie_winner(rows["leaf_packed"], ids)
            same_leaf = want >= 0
            assert same_leaf.sum() > 100
            np.testing.assert_array_equal(ids[same_leaf], want[same_leaf])


# ---- the reference's fault --------------------------------------------------

def test_reference_scripts_fail_on_the_current_tables(soup200, monkeypatch):
    """``kernel_stats.packet_stats`` on the JAX ``pack_bvh2``'s own output
    raises: at the current BLOCK_RAYS (2,048) the 8 x 128 plane reshape
    fails; at 1,024 the attribute-major read of the triangle-major leaf
    table fails to broadcast.  The port reads its own tables instead."""
    soup, bvh, _ = soup200["tree"]
    packed = jax_tp2.pack_bvh2(bvh, soup, leaf=jax_leaf_tables(bvh, soup))
    assert packed["leaff"].shape[0] == 8 and jax_stats.BLOCK_RAYS == 2048
    cast = soup200["cast"]
    args = (jnp.asarray(cast["origin"]), jnp.asarray(cast["direction"]),
            packed)
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(TypeError, match="cannot reshape"):
            jax_stats.packet_stats(*args)
        monkeypatch.setattr(jax_stats, "BLOCK_RAYS", 1024)
        with pytest.raises(ValueError, match="Incompatible shapes"):
            jax_stats.packet_stats(*args)


# ---- the wrapper and the tools ----------------------------------------------

def test_wrapper_takes_the_plain_version_on_the_cpu(soup200):
    """A CPU tensor runs the plain version (its ``calls`` counts, the
    kernel's ``launches`` does not); a tensor on another device raises
    with no fallback, as do an unknown variant and, for the kernel, a
    packet size it does not take."""
    c = _torch(soup200["cast"])
    launches, calls = pw.packet_walk.launches, pw.packet_walk_plain.calls
    pw.packet_walk(**c, tables=soup200["port"], variant="full")
    assert pw.packet_walk.launches == launches
    assert pw.packet_walk_plain.calls == calls + 1
    meta = {k: v.to("meta") for k, v in c.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        pw.packet_walk(**meta, tables=soup200["port"])
    with pytest.raises(ValueError, match="the kernel takes"):
        pw.packet_walk(**meta, tables=soup200["port"], packet=64, group=32)
    with pytest.raises(ValueError, match="unknown variant"):
        pw.packet_walk(**c, tables=soup200["port"], variant="fast")
    assert pw.packet_walk.launches == launches


@pytest.fixture(scope="module")
def small_teapots(tmp_path_factory):
    """The teapots preset at 16 x 16 on the CPU, its teapot.obj written by
    the port's generator: a BVH2-route scene (12,656 triangles)."""
    return teapots_scene(tmp_path_factory.mktemp("teapots"), 16, 16, "cpu")


def test_kernel_stats_tool_runs_on_the_cpu(small_teapots):
    """kernel_stats end to end on the CPU: the three populations at both
    packet sizes through the plain walk, each report's four lines, its
    figures those of the recorded counts, the casts Morton-sorted."""
    lines = []
    calls = pw.packet_walk_plain.calls
    records = kernel_stats.run(small_teapots, out=lines.append)
    assert [(r["population"], r["packet"]) for r in records] == [
        (p, size) for p in ("camera rays", "depth-2 bounce rays",
                            "connection casts (t=2,s=2)")
        for size, _ in pw.SIZES]
    assert pw.packet_walk_plain.calls == calls + 6
    assert len(lines) == 4 * len(records)
    assert lines[0].startswith("camera rays [1024-ray packets]: 1 packets")
    tables = kernel_stats.bvh2_tables(small_teapots)
    for r in records:
        stats, fig = r["stats"], r["figures"]
        assert stats.shape == (fig["packets"], 3) and (stats[:, 0] >= 1).all()
        assert fig["pops_per_packet"] == stats[:, 0].sum() / len(stats)
        c = r["cast"]
        key = intersect.morton_key(c["origin"], c["direction"], tables["lo"],
                                   tables["hi"], c["active"])
        assert (key[1:] >= key[:-1]).all()
    assert records[0]["cast"]["origin"].shape == (256, 3)
    assert records[2]["cast"]["origin"].shape == (512, 3)
    assert records[4]["cast"]["t_max"] is not None


def test_kernel_microbench_tool_runs_on_the_cpu(small_teapots):
    """kernel_microbench end to end on the CPU on two variants: a line per
    variant and packet size, the records' outputs the walk's; an unknown
    variant raises."""
    lines = []
    cast, records, yardstick = kernel_microbench.run(
        small_teapots, ["full", "noleaf"], out=lines.append)
    assert yardstick is None and len(records) == 4 and len(lines) == 6
    assert "cpu, plain version" in lines[0]
    full = next(r for r in records if r["variant"] == "full"
                and r["packet"] == 1024)
    assert (full["id"] >= 0).any()
    noleaf = next(r for r in records if r["variant"] == "noleaf")
    assert (noleaf["id"] == -1).all()
    with pytest.raises(ValueError, match="unknown variants"):
        kernel_microbench.run(small_teapots, ["fast"])


def test_tools_refuse_a_scene_off_the_bvh2_route():
    """As the JAX tool asserts its pallas tables: a brute scene (Cornell,
    16 triangles) raises; so does --device cuda without a card."""
    import clive2_tpu_torch as ct

    cornell = ct.create_scene_from_preset("empty", 8, 8, device="cpu")
    with pytest.raises(ValueError, match="not on the BVH2 route"):
        kernel_stats.bvh2_tables(cornell)
    if not torch.cuda.is_available():
        for main in (kernel_stats.main, kernel_microbench.main):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main(["teapots", "16", "--device", "cuda"])
