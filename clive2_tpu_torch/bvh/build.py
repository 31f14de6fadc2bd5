"""Host-side SAH BVH build and TPU-friendly flattening.

Rebuild of the reference builder (reference src/bvh.py:132-191 object
split, :288-313 construct, :329-389 flatten) with two deliberate departures:

* The build operates on **index arrays** into a single TriangleSoup instead of
  copying per-node triangle payloads, so large meshes build much faster.
* The flat layout is a **DFS-preorder threaded tree with miss links**
  ("skip pointers") rather than the reference's BFS left/right encoding.
  A ray's traversal state is then one integer node pointer:

      hit inner box  -> next = node + 1          (left child, preorder)
      hit leaf box   -> intersect leaf triangles, then next = miss[node]
      missed box     -> next = miss[node]
      next == n_nodes -> done

  This removes the per-thread 64-deep stack of trace.metal:145 and makes the
  walk maskable/vectorizable over TPU lanes (see ops/intersect.py), at the
  cost of fixed (unordered) descent.  ``right_child`` is also stored for
  stack-style kernels (Pallas packet traversal).

Leaf triangles are re-ordered to be contiguous per leaf and additionally
exported as a fixed-width padded table ``[n_leaves, MAX_MEMBERS]`` so the
traversal inner loop is a dense, maskable 8-wide Möller–Trumbore.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import MAX_MEMBERS
from ..geometry import TriangleSoup

try:  # optional native (C++) split kernel
    from . import native as _native
except Exception:  # pragma: no cover
    _native = None


def _surface_areas(mins: np.ndarray, maxes: np.ndarray) -> np.ndarray:
    spans = maxes - mins
    return 2.0 * (
        spans[..., 0] * spans[..., 1]
        + spans[..., 1] * spans[..., 2]
        + spans[..., 2] * spans[..., 0]
    )


def _object_split(mins, maxes, centers, idx):
    """Full-sweep SAH over 3 axes for the triangle subset ``idx``.

    Same heuristic family as reference bvh.py:132-159, with corrected
    left/right counts (the reference weights by ``arange`` which is off by
    one; image output is unaffected — split quality only).
    Returns (left_idx, right_idx).
    """
    n = len(idx)
    best_sah = np.inf
    best_i = 0
    best_sort = None
    sub_min = mins[idx]
    sub_max = maxes[idx]
    counts = np.arange(1, n, dtype=np.float64)
    for axis in range(3):
        order = np.argsort(centers[idx, axis], kind="stable")
        ltr_max = np.maximum.accumulate(sub_max[order], axis=0)
        ltr_min = np.minimum.accumulate(sub_min[order], axis=0)
        rtl_max = np.maximum.accumulate(sub_max[order[::-1]], axis=0)[::-1]
        rtl_min = np.minimum.accumulate(sub_min[order[::-1]], axis=0)[::-1]
        left_sa = _surface_areas(ltr_min, ltr_max)[:-1]
        right_sa = _surface_areas(rtl_min, rtl_max)[1:]
        sah = left_sa * counts + right_sa * (n - counts)
        i = int(np.argmin(sah))
        if sah[i] < best_sah:
            best_sah = sah[i]
            best_i = i + 1
            best_sort = order
    return idx[best_sort[:best_i]], idx[best_sort[best_i:]]


@dataclasses.dataclass
class FlatBVH:
    """Preorder threaded BVH + the leaf-sorted triangle permutation."""

    node_mins: np.ndarray     # [n, 3] f32
    node_maxes: np.ndarray    # [n, 3] f32
    miss: np.ndarray          # [n] i32; == n means terminate
    right_child: np.ndarray   # [n] i32; 0 for leaves (node 0 is the root)
    tri_start: np.ndarray     # [n] i32 into permuted triangle order
    tri_count: np.ndarray     # [n] i32; 0 for inner nodes
    leaf_id: np.ndarray       # [n] i32; -1 for inner nodes
    permutation: np.ndarray   # [T] i32: new order -> original triangle index
    n_leaves: int
    max_leaf_size: int = MAX_MEMBERS

    @property
    def n_nodes(self) -> int:
        return int(self.node_mins.shape[0])


def build_bvh(soup: TriangleSoup, max_members: int = MAX_MEMBERS,
              use_native: bool | None = None) -> FlatBVH:
    """SAH build + preorder threaded flatten.

    ``use_native`` selects the C++ split kernel when available (default:
    auto).  The pure-numpy path is the oracle; both produce identical trees
    given identical argsort tie-breaking.
    """
    mins = soup.mins.astype(np.float64)
    maxes = soup.maxes.astype(np.float64)
    centers = (mins + maxes) * 0.5
    n_tris = len(soup)

    if use_native is None:
        use_native = _native is not None and _native.available()
    if use_native and _native is not None and _native.available():
        return _native.build_bvh_native(soup, max_members)

    # ---- build: binary tree over index arrays -----------------------------
    # nodes as parallel python lists; children filled in as we split.
    node_tris: list = []    # index array per node (leaves), None for inner
    node_left: list = []
    node_right: list = []
    node_min: list = []
    node_max: list = []

    def new_node(idx) -> int:
        node_tris.append(idx)
        node_left.append(-1)
        node_right.append(-1)
        if len(idx):
            node_min.append(mins[idx].min(axis=0))
            node_max.append(maxes[idx].max(axis=0))
        else:
            node_min.append(np.full(3, np.inf))
            node_max.append(np.full(3, -np.inf))
        return len(node_tris) - 1

    root = new_node(np.arange(n_tris, dtype=np.int64))
    stack = [root]
    while stack:
        ni = stack.pop()
        idx = node_tris[ni]
        if len(idx) <= max_members:
            continue
        left_idx, right_idx = _object_split(mins, maxes, centers, idx)
        node_tris[ni] = None
        li = new_node(left_idx)
        ri = new_node(right_idx)
        node_left[ni] = li
        node_right[ni] = ri
        stack.append(ri)
        stack.append(li)

    return _flatten(
        node_min, node_max, node_left, node_right, node_tris, root,
        n_tris, max_members,
    )


def _flatten(node_min, node_max, node_left, node_right, node_tris, root,
             n_tris, max_members) -> FlatBVH:
    n_nodes = len(node_min)

    # subtree sizes via iterative post-order
    size = np.ones(n_nodes, dtype=np.int64)
    order = []
    stack = [root]
    while stack:
        ni = stack.pop()
        order.append(ni)
        if node_left[ni] >= 0:
            stack.append(node_left[ni])
            stack.append(node_right[ni])
    for ni in reversed(order):
        if node_left[ni] >= 0:
            size[ni] = 1 + size[node_left[ni]] + size[node_right[ni]]

    out_min = np.zeros((n_nodes, 3), dtype=np.float32)
    out_max = np.zeros((n_nodes, 3), dtype=np.float32)
    miss = np.full(n_nodes, n_nodes, dtype=np.int32)
    right_child = np.zeros(n_nodes, dtype=np.int32)
    tri_start = np.zeros(n_nodes, dtype=np.int32)
    tri_count = np.zeros(n_nodes, dtype=np.int32)
    leaf_id = np.full(n_nodes, -1, dtype=np.int32)
    permutation = np.zeros(n_tris, dtype=np.int32)

    # preorder assignment: (node, flat_index, miss_index)
    tri_cursor = 0
    leaf_cursor = 0
    stack = [(root, 0, n_nodes)]
    while stack:
        ni, fi, mi = stack.pop()
        out_min[fi] = node_min[ni]
        out_max[fi] = node_max[ni]
        miss[fi] = mi
        if node_left[ni] >= 0:
            left_fi = fi + 1
            right_fi = fi + 1 + int(size[node_left[ni]])
            right_child[fi] = right_fi
            stack.append((node_right[ni], right_fi, mi))
            stack.append((node_left[ni], left_fi, right_fi))
        else:
            idx = node_tris[ni]
            c = len(idx)
            tri_start[fi] = tri_cursor
            tri_count[fi] = c
            leaf_id[fi] = leaf_cursor
            permutation[tri_cursor : tri_cursor + c] = idx
            tri_cursor += c
            leaf_cursor += 1

    assert tri_cursor == n_tris, "flatten must cover all triangles exactly once"
    return FlatBVH(
        node_mins=out_min,
        node_maxes=out_max,
        miss=miss,
        right_child=right_child,
        tri_start=tri_start,
        tri_count=tri_count,
        leaf_id=leaf_id,
        permutation=permutation,
        n_leaves=leaf_cursor,
        max_leaf_size=max_members,
    )


def leaf_tables(bvh: FlatBVH, soup: TriangleSoup):
    """Padded per-leaf triangle table for the traversal inner loop.

    Returns dict of arrays shaped [n_leaves, max_leaf_size, ...]:
    v0, e1, e2 (Möller–Trumbore precomputation), tri_index (into the
    *original* soup order; -1 padding).
    """
    L, K = bvh.n_leaves, bvh.max_leaf_size
    n_tris = len(soup)

    leaf_nodes = np.nonzero(bvh.leaf_id >= 0)[0]
    lids = bvh.leaf_id[leaf_nodes]
    starts = bvh.tri_start[leaf_nodes].astype(np.int64)
    counts = bvh.tri_count[leaf_nodes].astype(np.int64)

    k = np.arange(K, dtype=np.int64)
    valid = k[None, :] < counts[:, None]                      # [L, K]
    src = np.minimum(starts[:, None] + k[None, :], n_tris - 1)
    orig = bvh.permutation[src]                               # [L, K]

    verts = soup.vertices[orig]                               # [L, K, 3, 3]
    v0 = np.zeros((L, K, 3), dtype=np.float32)
    e1 = np.zeros((L, K, 3), dtype=np.float32)
    e2 = np.zeros((L, K, 3), dtype=np.float32)
    tri_index = np.full((L, K), -1, dtype=np.int32)
    mask3 = valid[..., None]
    v0[lids] = np.where(mask3, verts[:, :, 0], 0.0)
    e1[lids] = np.where(mask3, verts[:, :, 1] - verts[:, :, 0], 0.0)
    e2[lids] = np.where(mask3, verts[:, :, 2] - verts[:, :, 0], 0.0)
    tri_index[lids] = np.where(valid, orig, -1).astype(np.int32)
    return dict(v0=v0, e1=e1, e2=e2, tri_index=tri_index)
