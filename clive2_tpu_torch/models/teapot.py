"""The exact Utah teapot: Newell's 32 bicubic Bézier patches, tessellated.

The control data below is the canonical public-domain dataset (Martin
Newell, 1975), in the compact 127-point / 10-base-patch form popularized
by GLUT's teapot.c: the six rotationally symmetric parts (rim, two body
bands, two lid patches, bottom) store one quarter and are rotated 4x
about the up axis; the handle and spout store one half and are mirrored.
Expanded, that is the standard 32-patch teapot.  At the classic 10x10
tessellation the mesh has 6,320 triangles (6,400 minus the 80 degenerate
pole slivers), matching the widely distributed teapot.obj — the file the
reference's "teapots" preset loads (reference src/scene.py:159-166,
load via load.py:76-83).

Data layout notes (faithfully kept from the canonical set): circle rows
use the teapot's historical 0.56 control factor (e.g. 0.784 = 1.4 * 0.56)
— not the mathematically closer 0.5523; the 0.8-radius lid circle uses
0.45 (factor 0.5625); point 28 (-2, 0, 0.9) sits amid the body rows but
belongs to the handle's last row.  Source data is z-up; ``utah_teapot``
returns y-up with the base at y = 0 (the orientation scene presets
expect).
"""

from __future__ import annotations

import numpy as np

# 127 control points, z-up, y <= 0 quadrant/half (index comments = row id)
TEAPOT_CP = np.array([
    [0.2, 0.0, 2.7], [0.2, -0.112, 2.7], [0.112, -0.2, 2.7],          # 0-2
    [0.0, -0.2, 2.7],                                                 # 3
    [1.3375, 0.0, 2.53125], [1.3375, -0.749, 2.53125],                # 4-5
    [0.749, -1.3375, 2.53125], [0.0, -1.3375, 2.53125],               # 6-7
    [1.4375, 0.0, 2.53125], [1.4375, -0.805, 2.53125],                # 8-9
    [0.805, -1.4375, 2.53125], [0.0, -1.4375, 2.53125],               # 10-11
    [1.5, 0.0, 2.4], [1.5, -0.84, 2.4], [0.84, -1.5, 2.4],            # 12-14
    [0.0, -1.5, 2.4],                                                 # 15
    [1.75, 0.0, 1.875], [1.75, -0.98, 1.875], [0.98, -1.75, 1.875],   # 16-18
    [0.0, -1.75, 1.875],                                              # 19
    [2.0, 0.0, 1.35], [2.0, -1.12, 1.35], [1.12, -2.0, 1.35],         # 20-22
    [0.0, -2.0, 1.35],                                                # 23
    [2.0, 0.0, 0.9], [2.0, -1.12, 0.9], [1.12, -2.0, 0.9],            # 24-26
    [0.0, -2.0, 0.9],                                                 # 27
    [-2.0, 0.0, 0.9],                                                 # 28 (handle)
    [2.0, 0.0, 0.45], [2.0, -1.12, 0.45], [1.12, -2.0, 0.45],         # 29-31
    [0.0, -2.0, 0.45],                                                # 32
    [1.5, 0.0, 0.225], [1.5, -0.84, 0.225], [0.84, -1.5, 0.225],      # 33-35
    [0.0, -1.5, 0.225],                                               # 36
    [1.5, 0.0, 0.15], [1.5, -0.84, 0.15], [0.84, -1.5, 0.15],         # 37-39
    [0.0, -1.5, 0.15],                                                # 40
    [-1.6, 0.0, 2.025], [-1.6, -0.3, 2.025], [-1.5, -0.3, 2.25],      # 41-43
    [-1.5, 0.0, 2.25],                                                # 44
    [-2.3, 0.0, 2.025], [-2.3, -0.3, 2.025], [-2.5, -0.3, 2.25],      # 45-47
    [-2.5, 0.0, 2.25],                                                # 48
    [-2.7, 0.0, 2.025], [-2.7, -0.3, 2.025], [-3.0, -0.3, 2.25],      # 49-51
    [-3.0, 0.0, 2.25],                                                # 52
    [-2.7, 0.0, 1.8], [-2.7, -0.3, 1.8], [-3.0, -0.3, 1.8],           # 53-55
    [-3.0, 0.0, 1.8],                                                 # 56
    [-2.7, 0.0, 1.575], [-2.7, -0.3, 1.575], [-3.0, -0.3, 1.35],      # 57-59
    [-3.0, 0.0, 1.35],                                                # 60
    [-2.5, 0.0, 1.125], [-2.5, -0.3, 1.125], [-2.65, -0.3, 0.9375],   # 61-63
    [-2.65, 0.0, 0.9375],                                             # 64
    [-2.0, -0.3, 0.9], [-1.9, -0.3, 0.6], [-1.9, 0.0, 0.6],           # 65-67
    [1.7, 0.0, 1.425], [1.7, -0.66, 1.425], [1.7, -0.66, 0.6],        # 68-70
    [1.7, 0.0, 0.6],                                                  # 71
    [2.6, 0.0, 1.425], [2.6, -0.66, 1.425], [3.1, -0.66, 0.825],      # 72-74
    [3.1, 0.0, 0.825],                                                # 75
    [2.3, 0.0, 2.1], [2.3, -0.25, 2.1], [2.4, -0.25, 2.025],          # 76-78
    [2.4, 0.0, 2.025],                                                # 79
    [2.7, 0.0, 2.4], [2.7, -0.25, 2.4], [3.3, -0.25, 2.4],            # 80-82
    [3.3, 0.0, 2.4],                                                  # 83
    [2.8, 0.0, 2.475], [2.8, -0.25, 2.475],                           # 84-85
    [3.525, -0.25, 2.49375], [3.525, 0.0, 2.49375],                   # 86-87
    [2.9, 0.0, 2.475], [2.9, -0.15, 2.475],                           # 88-89
    [3.45, -0.15, 2.5125], [3.45, 0.0, 2.5125],                       # 90-91
    [2.8, 0.0, 2.4], [2.8, -0.15, 2.4], [3.2, -0.15, 2.4],            # 92-94
    [3.2, 0.0, 2.4],                                                  # 95
    [0.0, 0.0, 3.15],                                                 # 96 (knob apex)
    [0.8, 0.0, 3.15], [0.8, -0.45, 3.15], [0.45, -0.8, 3.15],         # 97-99
    [0.0, -0.8, 3.15],                                                # 100
    [0.0, 0.0, 2.85],                                                 # 101 (knob pinch)
    [1.4, 0.0, 2.4], [1.4, -0.784, 2.4], [0.784, -1.4, 2.4],          # 102-104
    [0.0, -1.4, 2.4],                                                 # 105
    [0.4, 0.0, 2.55], [0.4, -0.224, 2.55], [0.224, -0.4, 2.55],       # 106-108
    [0.0, -0.4, 2.55],                                                # 109
    [1.3, 0.0, 2.55], [1.3, -0.728, 2.55], [0.728, -1.3, 2.55],       # 110-112
    [0.0, -1.3, 2.55],                                                # 113
    [1.3, 0.0, 2.4], [1.3, -0.728, 2.4], [0.728, -1.3, 2.4],          # 114-116
    [0.0, -1.3, 2.4],                                                 # 117
    [0.0, 0.0, 0.0],                                                  # 118 (base apex)
    [1.425, -0.798, 0.0], [1.5, -0.84, 0.075], [0.798, -1.425, 0.0],  # 119-121
    [0.84, -1.5, 0.075], [0.0, -1.425, 0.0], [0.0, -1.5, 0.075],      # 122-124
    [1.425, 0.0, 0.0], [1.5, 0.0, 0.075],                             # 125-126
], dtype=np.float64)

# 10 base patches: 4x4 control grids, row-major (rows advance along the
# profile, columns sweep the quarter circle / tube cross-section)
TEAPOT_PATCHES = np.array([
    # rim
    [102, 103, 104, 105, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    # body (upper band, lower band)
    [12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27],
    [24, 25, 26, 27, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40],
    # lid (knob, skirt)
    [96, 96, 96, 96, 97, 98, 99, 100, 101, 101, 101, 101, 0, 1, 2, 3],
    [0, 1, 2, 3, 106, 107, 108, 109, 110, 111, 112, 113, 114, 115, 116, 117],
    # bottom (apex -> z=0 ring -> z=0.075 ring -> body's z=0.15 ring)
    [118, 118, 118, 118, 125, 119, 121, 123, 126, 120, 122, 124,
     37, 38, 39, 40],
    # handle (upper arc, lower arc; row 28 reattaches to the body)
    [41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56],
    [53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 28, 65, 66, 67],
    # spout
    [68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83],
    [80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95],
], dtype=np.int64)

N_ROTATIONAL = 6      # first 6 base patches revolve 4x; last 4 mirror 2x


def _bezier_matrix(n: int) -> np.ndarray:
    """[n+1, 4] cubic Bernstein basis sampled at n+1 uniform parameters."""
    t = np.linspace(0.0, 1.0, n + 1)[:, None]
    return np.concatenate([
        (1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t), t ** 3,
    ], axis=1)


def expand_patches():
    """The full 32-patch set as [32, 4, 4, 3] control grids (z-up).

    Rotational parts: the stored quarter sweeps angles [0, -90deg]; three
    z-rotations by 90deg complete the circle.  Handle/spout: the stored
    half (y <= 0) plus its y-mirror.  Mirrored/odd-rotation copies get a
    column flip so every patch keeps the same outward orientation.
    """
    rot90 = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    mirror_y = np.diag([1.0, -1.0, 1.0])

    out = []
    for p_idx, patch in enumerate(TEAPOT_PATCHES):
        grid = TEAPOT_CP[patch].reshape(4, 4, 3)
        if p_idx < N_ROTATIONAL:
            m = np.eye(3)
            for _ in range(4):
                out.append(grid @ m.T)
                m = rot90 @ m
        else:
            out.append(grid)
            out.append((grid @ mirror_y.T)[:, ::-1])   # flip to fix winding
    return np.stack(out)


def utah_teapot(n: int = 10, scale: float = 1.0):
    """Tessellate the exact 32-patch teapot into (vertices, faces).

    ``n``: quads per patch edge (n=10 -> 6,320 triangles, the classic
    teapot.obj resolution).  Returns y-up geometry with the base ring at
    y = 0 spanning x in [-3, 3.434], height 3.15 — the raw dataset size,
    which the reference preset loads unscaled (scene.py:159-166).
    """
    basis = _bezier_matrix(n)                        # [n+1, 4]
    patches = expand_patches()                       # [32, 4, 4, 3]
    # S[u, v] = B(u) . G . B(v)^T per coordinate
    pts = np.einsum("ua,pabc,vb->puvc", basis, patches, basis)

    verts = []
    faces = []
    offset = 0
    for p in range(pts.shape[0]):
        g = pts[p].reshape(-1, 3)                    # [(n+1)^2, 3]
        verts.append(g)
        idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1) + offset
        a = idx[:-1, :-1].ravel()
        b = idx[1:, :-1].ravel()
        c = idx[1:, 1:].ravel()
        d = idx[:-1, 1:].ravel()
        faces.append(np.stack([a, b, c], axis=1))
        faces.append(np.stack([a, c, d], axis=1))
        offset += (n + 1) * (n + 1)

    v = np.concatenate(verts)
    f = np.concatenate(faces).astype(np.int32)

    # drop pole slivers (rows of coincident control points tessellate to
    # zero-area triangles at the lid apex and base apex)
    tri = v[f]
    area2 = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    f = f[area2 > 1e-12]

    # z-up -> y-up (keep right-handedness: x, y, z -> x, z, -y)
    v = np.stack([v[:, 0], v[:, 2], -v[:, 1]], axis=1) * scale
    return v, f
