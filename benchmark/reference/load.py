"""Frozen copy of clive2_tpu_torch/load.py: the PLY parser and writer and
the normal smoothing (the OBJ parts are left out; the configurations'
meshes are PLY).

The original renderer leans on the ``plyfile`` pip package (its
src/load.py:2,22); this module implements a small self-contained parser
of the subset those scenes need (ascii + binary-little-endian PLY).

Shading normals use angle-weighted vertex-normal smoothing, the same
algorithm as reference load.py:137-176.
"""

from __future__ import annotations

import struct as _struct

import numpy as np

from .geometry import TriangleSoup


# --------------------------------------------------------------------------
# parsers
# --------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "b", "int8": "b",
    "uchar": "B", "uint8": "B",
    "short": "h", "int16": "h",
    "ushort": "H", "uint16": "H",
    "int": "i", "int32": "i",
    "uint": "I", "uint32": "I",
    "float": "f", "float32": "f",
    "double": "d", "float64": "d",
}
_PLY_NP = {k: np.dtype(v) for k, v in _PLY_TYPES.items()}


def parse_ply(path: str):
    """Minimal PLY parser: returns (vertices [N,3] f64, faces [M,3] i32).

    Handles ascii and binary_little_endian formats, arbitrary extra vertex
    properties (skipped), and polygonal faces (fan-triangulated).
    """
    with open(path, "rb") as f:
        data = f.read()

    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_kind, ...)]) in declaration order
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise NotImplementedError(f"PLY format {fmt!r} not supported")

    vertices = None
    faces = []

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(tokens[pos : pos + count * width], dtype=np.float64)
                arr = arr.reshape(count, width)
                cols = {p[2]: i for i, p in enumerate(props)}
                vertices = arr[:, [cols["x"], cols["y"], cols["z"]]]
                pos += count * width
            elif name == "face":
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            n = int(tokens[pos]); pos += 1
                            idxs = [int(tokens[pos + i]) for i in range(n)]
                            pos += n
                            if p[3] == "vertex_indices" or p[3] == "vertex_index":
                                for k in range(1, n - 1):
                                    faces.append((idxs[0], idxs[k], idxs[k + 1]))
                        else:
                            pos += 1
            else:
                # skip unknown element (assume scalar-only)
                pos += count * len(props)
    else:
        off = 0
        for name, count, props in elements:
            is_fixed = all(p[0] == "scalar" for p in props)
            if name == "vertex" and is_fixed:
                dt = np.dtype([(p[2], _PLY_NP[p[1]].newbyteorder("<")) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                vertices = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=1
                ).astype(np.float64)
            elif (name == "face" and len(props) == 1
                    and props[0][0] == "list"
                    and props[0][3] in ("vertex_indices", "vertex_index")
                    and _PLY_NP[props[0][1]].itemsize == 1):
                # vectorized fast path for the universal layout (uchar
                # count + index list, no trailing face properties): a
                # pure-triangle block has fixed 1+3*isz-byte rows, so the
                # whole element parses as one reshape — the per-face
                # struct.unpack loop below costs ~4s/M faces
                isz = _PLY_NP[props[0][2]].itemsize
                idt = _PLY_NP[props[0][2]].newbyteorder("<")
                stride = 1 + 3 * isz
                raw = np.frombuffer(body, np.uint8, count * stride, off)
                raw = raw.reshape(count, stride)
                if (raw[:, 0] == 3).all():
                    faces = (np.ascontiguousarray(raw[:, 1:])
                             .view(idt).astype(np.int32).reshape(-1, 3))
                    off += count * stride
                else:
                    # polygons present: per-face offsets from the count
                    # bytes (counts live at the start of each variable-
                    # width row; walk them vectorized-ish in one pass)
                    for _ in range(count):
                        n = body[off]
                        off += 1
                        idxs = np.frombuffer(body, idt, n, off)
                        off += isz * n
                        for k in range(1, n - 1):
                            faces.append((int(idxs[0]), int(idxs[k]),
                                          int(idxs[k + 1])))
            else:
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cnt_t = _PLY_TYPES[p[1]]
                            idx_t = _PLY_TYPES[p[2]]
                            (n,) = _struct.unpack_from("<" + cnt_t, body, off)
                            off += _struct.calcsize(cnt_t)
                            idxs = _struct.unpack_from("<" + str(n) + idx_t, body, off)
                            off += _struct.calcsize(idx_t) * n
                            if name == "face" and p[3] in ("vertex_indices", "vertex_index"):
                                for k in range(1, n - 1):
                                    faces.append((idxs[0], idxs[k], idxs[k + 1]))
                        else:
                            off += _PLY_NP[p[1]].itemsize

    if vertices is None:
        raise ValueError(f"PLY file {path} has no vertex element")
    return vertices, np.asarray(faces, dtype=np.int32).reshape(-1, 3)


# --------------------------------------------------------------------------
# normal smoothing + soup assembly
# --------------------------------------------------------------------------

def _cross(a, b):
    """np.cross without its shape gymnastics (~3x faster on [M, 3, 3])."""
    out = np.empty(np.broadcast(a, b).shape, dtype=np.result_type(a, b))
    out[..., 0] = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    out[..., 1] = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    out[..., 2] = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return out


def smooth_vertex_normals(
    vertices: np.ndarray, faces: np.ndarray, face_normals: np.ndarray
) -> np.ndarray:
    """Angle-weighted vertex-normal smoothing (reference load.py:137-176).

    Each face's unit normal is accumulated at its three vertices weighted by
    the interior angle at that corner; the result is normalized per vertex.
    """
    v = vertices[faces]                       # [M, 3, 3]
    e_next = np.roll(v, -1, axis=1) - v
    e_prev = np.roll(v, 1, axis=1) - v
    cross_len = np.linalg.norm(_cross(e_next, e_prev), axis=2)
    dot = np.einsum("ijk,ijk->ij", e_next, e_prev)
    angles = np.arctan2(cross_len, dot)       # [M, 3]

    weighted = face_normals[:, None, :] * angles[..., None]  # [M, 3, 3]
    # scatter-accumulate via per-component bincount: np.add.at is an
    # unbuffered ufunc loop (~5s at 871k faces); bincount is ~20x faster
    idx = faces.ravel()
    w = weighted.reshape(-1, 3)
    v_n = np.stack(
        [np.bincount(idx, weights=w[:, c], minlength=len(vertices))
         for c in range(3)], axis=1)

    lens = np.linalg.norm(v_n, axis=1, keepdims=True)
    np.divide(v_n, lens, out=v_n, where=lens > 0)
    return v_n


def soup_from_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    material: int = 0,
    emitter: bool = False,
    scale: float = 1.0,
    offset=None,
) -> TriangleSoup:
    """Indexed mesh -> TriangleSoup with smoothed shading normals.

    Mirrors the reference's fast_load pipeline (load.py:98-134).
    """
    if offset is None:
        offset = np.zeros(3)
    vertices = np.asarray(vertices, dtype=np.float64) * scale + np.asarray(offset)
    tris = vertices[faces]                                 # [M, 3, 3]
    face_n = _cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norms = np.linalg.norm(face_n, axis=1, keepdims=True)
    unit_face_n = np.divide(face_n, norms, out=np.zeros_like(face_n), where=norms > 0)

    vert_n = smooth_vertex_normals(vertices, faces, unit_face_n)
    tri_vert_n = vert_n[faces]                             # [M, 3, 3]

    return TriangleSoup(
        vertices=tris.astype(np.float32),
        vertex_normals=tri_vert_n.astype(np.float32),
        face_normals=unit_face_n.astype(np.float32),
        material=np.full(len(tris), material, dtype=np.int32),
        is_light=np.full(len(tris), emitter, dtype=bool),
        is_camera=np.zeros(len(tris), dtype=bool),
    )


def load_ply(ply_path, material=0, scale=1.0, offset=None, emitter=False) -> TriangleSoup:
    vertices, faces = parse_ply(ply_path)
    return soup_from_mesh(
        vertices, faces, material=material, emitter=emitter, scale=scale, offset=offset
    )


def load_mesh_file(path, **kw) -> TriangleSoup:
    if str(path).endswith(".ply"):
        return load_ply(path, **kw)
    raise NotImplementedError(f"unsupported mesh format: {path}")


# --------------------------------------------------------------------------
# writer (used by the procedural mesh generator, ``meshgen.py``)
# --------------------------------------------------------------------------

def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              binary: bool = True):
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(vertices.astype("<f4").tobytes())
            counts = np.full((len(faces), 1), 3, dtype=np.uint8)
            rows = b"".join(
                counts[i].tobytes() + faces[i].astype("<i4").tobytes()
                for i in range(len(faces))
            )
            f.write(rows)
    else:
        with open(path, "w") as f:
            f.write(header)
            for v in vertices:
                f.write(f"{v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
            for fc in faces:
                f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
