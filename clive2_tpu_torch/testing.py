"""Inputs that hold the kernels to their rules: a soup of triangles that
each appear twice, so that every hit is an exact tie in t (the traversal
kernels' tie rule), and rays at the edges of the brute-force test and of
its early-reject pre-test.

Used by the CPU tests (with the JAX package's tree) and by chip_smoke.py
and the card tests (with the port's tree).
"""

from __future__ import annotations

import numpy as np


def swap_pair_ids(leaf_packed, t, rng):
    """Swap the ids of a random half of the pairs in the gather walk's leaf
    rows of a soup whose triangle i + t is a copy of triangle i (i < t), so
    that the lower slot (leaf * 8 + k) does not always hold the lower id.

    Returns (leaf rows, lower): ``lower(ids)`` is the id at the lower slot
    of each id's pair, the id the tie rule must report."""
    flat = np.asarray(leaf_packed).reshape(-1, 10).copy()
    swap = np.arange(2 * t)
    half = np.nonzero(rng.uniform(size=t) < 0.5)[0]
    swap[half], swap[half + t] = half + t, half
    filled = flat[:, 9] >= 0
    geom = flat[filled, 9].astype(np.int64)         # geometry of each slot
    flat[filled, 9] = swap[geom]
    slot_of = np.empty(2 * t, np.int64)             # geometry -> slot
    slot_of[geom] = np.nonzero(filled)[0]

    def lower(ids):
        k = swap[ids] % t                           # the pair hit
        return swap[np.where(slot_of[k] < slot_of[k + t], k, k + t)]

    return flat.reshape(np.shape(leaf_packed)), lower


def tie_soup(seed, t):
    """The port's gather-walk rows of a soup of ``t`` random triangles
    (centres in [-5, 5]^3, vertices within 0.4) each twice, with the ids of
    half of the pairs swapped (``swap_pair_ids``).  Returns (rows,
    lower)."""
    from .bvh.build import build_bvh, leaf_tables
    from .geometry import TriangleSoup
    from .ops.intersect import pack_gather_walk

    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (t, 1, 3))
    base = (c + rng.uniform(-0.4, 0.4, (t, 3, 3))).astype(np.float32)
    soup = TriangleSoup.from_vertices(np.concatenate([base, base]))
    bvh = build_bvh(soup)
    rows = pack_gather_walk(bvh, leaf_tables(bvh, soup))
    rows["leaf_packed"], lower = swap_pair_ids(rows["leaf_packed"], t, rng)
    return rows, lower


def brute_edge_cases():
    """Rays at the edges of the brute-force test and of its early-reject
    pre-test (csrc/brute.cu's note), built by hand, and the two triangles they are built for: (origins [N,
    3], directions [N, 3], brute table [2, 10]), all f32.  Ray 0 hits
    triangle 1 with u = f U underflowing to -0.0, which a test of U's sign
    alone would reject."""
    f32 = np.float32
    big = f32(2.0 ** 60)
    unit = np.array([[0, 0, 0, 1, 0, 0, 0, 1, 0, 0]], f32)   # x, y plane
    huge = np.array([[0, 0, 0, big, 0, 0, 0, big, 0, 0]], f32)
    delta = f32(1e-4)
    cases = [
        # u = f U underflows to -0.0 (U < 0, a = 2^120): plain accepts
        (huge, [-(2.0 ** -149), 2.0 ** 58, 5.0], [0, 0, -1]),
        # t = f T underflows to -0.0: plain rejects (t > kDelta fails)
        (huge, [2.0 ** 58, 2.0 ** 58, -(2.0 ** -149)], [0, 0, -1]),
        # a = +0 and a = -0: rays in the triangle's plane
        (unit, [0.2, 0.2, 0.0], [1, 0, 0]),
        (unit, [0.2, 0.2, 0.0], [-1, 0, 0]),
        (unit, [0.2, 0.2, 0.0], [0, -1, 0]),
        # u exactly 0, u exactly 1, v exactly 0, u + v exactly 1
        (unit, [0.0, 0.3, 1.0], [0, 0, -1]),
        (unit, [1.0, 0.0, 1.0], [0, 0, -1]),
        (unit, [0.3, 0.0, 1.0], [0, 0, -1]),
        (unit, [0.5, 0.5, 1.0], [0, 0, -1]),
        (unit, [0.25, 0.75, 1.0], [0, 0, -1]),
        # just outside each edge, by one ulp and by the margin
        (unit, [np.nextafter(f32(1), f32(2)), 0.0, 1.0], [0, 0, -1]),
        (unit, [-(2.0 ** -30), 0.5, 1.0], [0, 0, -1]),
        (unit, [0.5, np.nextafter(f32(0.5), f32(1)), 1.0], [0, 0, -1]),
        (unit, [1.0 + 2.0 ** -21, 0.0, 1.0], [0, 0, -1]),
        (unit, [1.0 + 2.0 ** -19, 0.0, 1.0], [0, 0, -1]),
        # t exactly kDelta (rejected) and just past it (accepted)
        (unit, [0.2, 0.2, delta], [0, 0, -1]),
        (unit, [0.2, 0.2, np.nextafter(delta, f32(1))], [0, 0, -1]),
        # t just below 0 and just above: behind and in front
        (unit, [0.2, 0.2, -(2.0 ** -30)], [0, 0, -1]),
        (unit, [0.2, 0.2, 1.0], [0, 0, 1]),
        # a grazing ray (tiny a) and a ray from below (a < 0)
        (unit, [0.2, 0.2, 1.0], [0, 2.0 ** -40, -1]),
        (unit, [0.2, 0.3, -1.0], [0, 0, 1]),
        (unit, [0.2, 0.3, 1.0], [2.0 ** -100, 0, -(2.0 ** -100)]),
    ]
    o = np.array([c[1] for c in cases], f32)
    d = np.array([c[2] for c in cases], f32)
    return o, d, np.concatenate([unit, huge])
