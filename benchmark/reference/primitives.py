"""The procedural mesh of the Sponza-scale configuration (frozen copy of
``uv_sphere``, ``_fbm3`` and ``displaced_blob_exact`` from
clive2_tpu_torch/models/primitives.py).  ``meshgen.py`` writes it as the
program's ``make_assets`` does.
"""

from __future__ import annotations

import numpy as np


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
