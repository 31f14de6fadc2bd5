"""Inputs that hold the traversal kernels to their tie rule: a soup of
triangles that each appear twice, so that every hit is an exact tie in t.

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
