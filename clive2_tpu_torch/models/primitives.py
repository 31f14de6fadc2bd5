"""Procedural mesh primitives: icosphere, surfaces of revolution, fbm blobs.

All generators return (vertices [N, 3] f64, faces [M, 3] i32) indexed
meshes suitable for load.soup_from_mesh / load.write_obj / write_ply.
"""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 3):
    """Unit icosphere via repeated 4-way subdivision of an icosahedron.
    Triangle count: 20 * 4^subdivisions."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    for _ in range(subdivisions):
        verts_list = list(verts)
        midpoint_cache: dict = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key in midpoint_cache:
                return midpoint_cache[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            idx = len(verts_list) - 1
            midpoint_cache[key] = idx
            return idx

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return verts, faces.astype(np.int32)


def revolve(profile_r, profile_y, segments: int = 48, close_top=True,
            close_bottom=True):
    """Surface of revolution around the y axis.

    profile_r/profile_y: radii and heights of the profile polyline
    (bottom to top).  Zero radii at the ends produce poles.
    """
    profile_r = np.asarray(profile_r, dtype=np.float64)
    profile_y = np.asarray(profile_y, dtype=np.float64)
    k = len(profile_r)
    theta = 2 * np.pi * np.arange(segments) / segments
    ct, st = np.cos(theta), np.sin(theta)

    verts = []
    rows = []
    for i in range(k):
        if profile_r[i] == 0.0:
            verts.append([0.0, profile_y[i], 0.0])
            rows.append(("pole", len(verts) - 1))
        else:
            base = len(verts)
            for j in range(segments):
                verts.append(
                    [profile_r[i] * ct[j], profile_y[i], profile_r[i] * st[j]]
                )
            rows.append(("ring", base))

    faces = []
    for i in range(k - 1):
        kind_a, a = rows[i]
        kind_b, b = rows[i + 1]
        if kind_a == "ring" and kind_b == "ring":
            for j in range(segments):
                jn = (j + 1) % segments
                faces.append([a + j, b + j, b + jn])
                faces.append([a + j, b + jn, a + jn])
        elif kind_a == "pole" and kind_b == "ring":
            for j in range(segments):
                jn = (j + 1) % segments
                faces.append([a, b + j, b + jn])
        elif kind_a == "ring" and kind_b == "pole":
            for j in range(segments):
                jn = (j + 1) % segments
                faces.append([a + j, b, a + jn])
    return np.asarray(verts), np.asarray(faces, dtype=np.int32)


def _fbm3(p: np.ndarray, octaves: int = 4, seed: int = 0) -> np.ndarray:
    """Cheap value-noise fbm on points [N, 3] via hashed trilinear lattice."""
    rng_gains = [0.5 ** o for o in range(octaves)]
    total = np.zeros(len(p))
    for o, gain in enumerate(rng_gains):
        q = p * (2.0 ** o) * 1.7 + o * 11.13
        qi = np.floor(q).astype(np.int64)
        qf = q - qi
        qf = qf * qf * (3 - 2 * qf)  # smoothstep

        def hash_lattice(offs):
            h = qi + offs
            n = (
                h[:, 0] * 374761393 + h[:, 1] * 668265263 + h[:, 2] * 2147483647
                + seed * 1013904223
            )
            n = (n ^ (n >> 13)) * 1274126177
            n = n ^ (n >> 16)
            return (n % 65536) / 65536.0

        c = np.zeros(len(p))
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = (
                        (qf[:, 0] if dx else 1 - qf[:, 0])
                        * (qf[:, 1] if dy else 1 - qf[:, 1])
                        * (qf[:, 2] if dz else 1 - qf[:, 2])
                    )
                    c += w * hash_lattice(np.array([dx, dy, dz]))
        total += gain * (c - 0.5)
    return total


def displaced_blob(subdivisions: int = 4, amplitude: float = 0.35,
                   stretch=(1.6, 0.9, 1.0), seed: int = 3):
    """Organic fbm-displaced ellipsoid — the stand-in for the Stanford
    dragon PLYs (same triangle-count ballpark per resolution):
    subdiv 4 -> 5.1k tris, 5 -> 20k, 6 -> 82k, 7 -> 327k."""
    verts, faces = icosphere(subdivisions)
    disp = _fbm3(verts * 2.0, octaves=5, seed=seed)
    verts = verts * (1.0 + amplitude * disp)[:, None]
    verts = verts * np.asarray(stretch)[None, :]
    return verts, faces


def uv_sphere(n_lon: int, n_rings: int):
    """Watertight longitude/latitude sphere: two poles, ``n_rings``
    interior latitude rings of ``n_lon`` vertices; exactly
    2 * n_lon * n_rings triangles.  Unlike icosphere (powers of 4 only)
    this hits arbitrary triangle-count targets."""
    lat = np.pi * (np.arange(1, n_rings + 1)) / (n_rings + 1)  # (0, pi)
    lon = 2 * np.pi * np.arange(n_lon) / n_lon
    sl, cl = np.sin(lat)[:, None], np.cos(lat)[:, None]
    verts = [np.array([[0.0, 1.0, 0.0]])]
    verts.append(np.stack([
        (sl * np.cos(lon)[None, :]).ravel(),
        np.broadcast_to(cl, (n_rings, n_lon)).ravel(),
        (sl * np.sin(lon)[None, :]).ravel(),
    ], axis=1))
    verts.append(np.array([[0.0, -1.0, 0.0]]))
    v = np.concatenate(verts)

    j = np.arange(n_lon)
    jn = (j + 1) % n_lon
    ring = lambda i: 1 + i * n_lon
    faces = [np.stack([np.zeros(n_lon, np.int64), ring(0) + j, ring(0) + jn],
                      axis=1)]
    for i in range(n_rings - 1):
        a, b = ring(i), ring(i + 1)
        faces.append(np.stack([a + j, b + j, b + jn], axis=1))
        faces.append(np.stack([a + j, b + jn, a + jn], axis=1))
    south = len(v) - 1
    a = ring(n_rings - 1)
    faces.append(np.stack([a + j, np.full(n_lon, south, np.int64), a + jn],
                          axis=1))
    return v, np.concatenate(faces).astype(np.int32)


def displaced_blob_exact(target_tris: int, amplitude: float = 0.35,
                         stretch=(1.6, 0.9, 1.0), seed: int = 3):
    """``displaced_blob`` on a UV sphere sized to hit ``target_tris``
    (exactly 2 * n_lon * n_rings, the closest factorization to the
    target) — used so the dragon stand-ins carry the REAL Stanford
    triangle counts (res3 = 47,794; res2 = 202,520; full = 871,414)
    instead of the nearest icosphere power of four."""
    n_lon = max(8, int(round(np.sqrt(target_tris / 4.0))))
    n_rings = max(3, int(round(target_tris / (2.0 * n_lon))))
    verts, faces = uv_sphere(n_lon, n_rings)
    disp = _fbm3(verts * 2.0, octaves=5, seed=seed)
    verts = verts * (1.0 + amplitude * disp)[:, None]
    verts = verts * np.asarray(stretch)[None, :]
    return verts, faces


def teapot_like(segments: int = 40):
    """Pot-shaped surface of revolution with a lid knob — the stand-in for
    the Utah teapot OBJ (~6k tris at default segments)."""
    # body profile: foot, belly, shoulder, lid, knob
    r = [0.0, 0.55, 0.95, 1.15, 1.05, 0.8, 0.55, 0.5, 0.42, 0.25, 0.12, 0.18, 0.0]
    y = [0.0, 0.02, 0.28, 0.72, 1.12, 1.38, 1.5, 1.53, 1.6, 1.72, 1.82, 1.94, 2.05]
    body_v, body_f = revolve(r, y, segments=segments)

    # spout: skewed cone of rings
    spout_v = []
    spout_f = []
    rings = 8
    seg2 = max(8, segments // 3)
    theta = 2 * np.pi * np.arange(seg2) / seg2
    for i in range(rings):
        tfrac = i / (rings - 1)
        cx = 1.0 + 0.85 * tfrac          # extend outward in +x
        cy = 0.55 + 0.75 * tfrac         # and upward
        rad = 0.18 * (1 - 0.55 * tfrac)
        for j in range(seg2):
            spout_v.append(
                [cx + rad * 0.4 * np.cos(theta[j]),
                 cy + rad * np.sin(theta[j]),
                 rad * np.sin(theta[j] + np.pi / 2)]
            )
    for i in range(rings - 1):
        a, b = i * seg2, (i + 1) * seg2
        for j in range(seg2):
            jn = (j + 1) % seg2
            spout_f.append([a + j, b + j, b + jn])
            spout_f.append([a + j, b + jn, a + jn])

    # handle: torus arc on the -x side
    handle_v = []
    handle_f = []
    arc = 10
    seg3 = max(8, segments // 4)
    for i in range(arc):
        ang = np.pi * (0.15 + 0.7 * i / (arc - 1))
        cx = -1.0 - 0.45 * np.sin(ang)
        cy = 1.05 - 0.55 * np.cos(ang)
        rad = 0.09
        for j in range(seg3):
            t2 = 2 * np.pi * j / seg3
            handle_v.append(
                [cx + rad * np.cos(t2) * np.cos(ang),
                 cy + rad * np.cos(t2) * np.sin(ang),
                 rad * np.sin(t2)]
            )
    for i in range(arc - 1):
        a, b = i * seg3, (i + 1) * seg3
        for j in range(seg3):
            jn = (j + 1) % seg3
            handle_f.append([a + j, b + j, b + jn])
            handle_f.append([a + j, b + jn, a + jn])

    verts = np.concatenate(
        [body_v, np.asarray(spout_v), np.asarray(handle_v)], axis=0
    )
    faces = np.concatenate(
        [
            np.asarray(body_f),
            np.asarray(spout_f) + len(body_v),
            np.asarray(handle_f) + len(body_v) + len(spout_v),
        ],
        axis=0,
    ).astype(np.int32)
    return verts, faces
