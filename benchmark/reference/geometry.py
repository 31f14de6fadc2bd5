"""Frozen copy of clive2_tpu_torch/geometry.py.

SoA triangle-soup geometry.

Replaces the reference's AoS ``Triangle`` objects and ``FastTreeBox``
container (reference src/load.py:32-73, reference src/bvh.py:7-113)
with a single structure-of-arrays container.  There is no byte-level ABI
(reference struct_types.py) — device code consumes these arrays as a pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import (
    DEFAULT_BOX_MAX_CORNER,
    DEFAULT_BOX_MIN_CORNER,
    DEFAULT_LIGHT_HEIGHT,
    DEFAULT_LIGHT_SCALE,
    UNIT_X,
    UNIT_Y,
    UNIT_Z,
)


def _unit_rows(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.divide(v, n, out=np.zeros_like(v), where=n > 0)


@dataclasses.dataclass
class TriangleSoup:
    """Flat arrays describing T triangles.

    vertices:          [T, 3, 3] f32  (v0, v1, v2)
    vertex_normals:    [T, 3, 3] f32  smooth shading normals per corner
    face_normals:      [T, 3]    f32  unit geometric normals
    material:          [T] i32
    is_light:          [T] bool
    is_camera:         [T] bool
    """

    vertices: np.ndarray
    vertex_normals: np.ndarray
    face_normals: np.ndarray
    material: np.ndarray
    is_light: np.ndarray
    is_camera: np.ndarray

    def __len__(self) -> int:
        return int(self.vertices.shape[0])

    @classmethod
    def empty(cls) -> "TriangleSoup":
        z3 = np.empty((0, 3, 3), dtype=np.float32)
        return cls(
            vertices=z3.copy(),
            vertex_normals=z3.copy(),
            face_normals=np.empty((0, 3), dtype=np.float32),
            material=np.empty((0,), dtype=np.int32),
            is_light=np.empty((0,), dtype=bool),
            is_camera=np.empty((0,), dtype=bool),
        )

    @classmethod
    def from_vertices(
        cls,
        vertices: np.ndarray,
        material=0,
        is_light=False,
        is_camera=False,
        vertex_normals: np.ndarray | None = None,
    ) -> "TriangleSoup":
        """Build a soup from raw [T, 3, 3] corner positions.

        Without explicit ``vertex_normals``, shading normals are the flat
        face normals (matches FastTreeBox.from_triangle_objects,
        reference bvh.py:61-64).
        """
        vertices = np.asarray(vertices, dtype=np.float32)
        t = vertices.shape[0]
        face_n = np.cross(
            vertices[:, 1] - vertices[:, 0], vertices[:, 2] - vertices[:, 0]
        )
        face_n = _unit_rows(face_n).astype(np.float32)
        if vertex_normals is None:
            vertex_normals = np.repeat(face_n[:, None, :], 3, axis=1)
        return cls(
            vertices=vertices,
            vertex_normals=np.asarray(vertex_normals, dtype=np.float32),
            face_normals=face_n,
            material=np.broadcast_to(np.asarray(material, np.int32), (t,)).copy(),
            is_light=np.broadcast_to(np.asarray(is_light, bool), (t,)).copy(),
            is_camera=np.broadcast_to(np.asarray(is_camera, bool), (t,)).copy(),
        )

    def __add__(self, other: "TriangleSoup") -> "TriangleSoup":
        cat = lambda a, b: np.concatenate([a, b], axis=0)
        return TriangleSoup(
            vertices=cat(self.vertices, other.vertices),
            vertex_normals=cat(self.vertex_normals, other.vertex_normals),
            face_normals=cat(self.face_normals, other.face_normals),
            material=cat(self.material, other.material),
            is_light=cat(self.is_light, other.is_light),
            is_camera=cat(self.is_camera, other.is_camera),
        )

    def select(self, idx: np.ndarray) -> "TriangleSoup":
        return TriangleSoup(
            vertices=self.vertices[idx],
            vertex_normals=self.vertex_normals[idx],
            face_normals=self.face_normals[idx],
            material=self.material[idx],
            is_light=self.is_light[idx],
            is_camera=self.is_camera[idx],
        )

    @property
    def mins(self) -> np.ndarray:
        return self.vertices.min(axis=1)

    @property
    def maxes(self) -> np.ndarray:
        return self.vertices.max(axis=1)

    @property
    def centers(self) -> np.ndarray:
        return (self.mins + self.maxes) * 0.5

    def surface_areas(self) -> np.ndarray:
        e1 = self.vertices[:, 1] - self.vertices[:, 0]
        e2 = self.vertices[:, 2] - self.vertices[:, 0]
        return np.linalg.norm(np.cross(e1, e2), axis=-1) / 2


def _quad(a, b, c, d, material, is_light=False, is_camera=False) -> TriangleSoup:
    verts = np.array([[a, b, c], [a, c, d]], dtype=np.float32)
    return TriangleSoup.from_vertices(
        verts, material=material, is_light=is_light, is_camera=is_camera
    )


def box_geometry(
    box_min=DEFAULT_BOX_MIN_CORNER,
    box_max=DEFAULT_BOX_MAX_CORNER,
    light_height=DEFAULT_LIGHT_HEIGHT,
    light_scale=DEFAULT_LIGHT_SCALE,
) -> TriangleSoup:
    """Cornell-style room with a ceiling light.

    Triangle winding and materials match the reference
    (reference src/load.py:203-258) so images are comparable.
    """
    box_min = np.asarray(box_min, dtype=np.float64)
    box_max = np.asarray(box_max, dtype=np.float64)
    span = box_max - box_min
    lbb = box_min
    rbb = box_min + span * UNIT_X
    ltb = box_min + span * UNIT_Y
    lbf = box_min + span * UNIT_Z
    rtf = box_max
    ltf = box_max - span * UNIT_X
    rbf = box_max - span * UNIT_Y
    rtb = box_max - span * UNIT_Z

    shrink = np.array([light_scale, light_height, light_scale])

    tris = [
        # back wall
        ([lbb, rbb, rtb], 4, False),
        ([lbb, rtb, ltb], 4, False),
        # left wall
        ([lbb, ltf, lbf], 1, False),
        ([lbb, ltb, ltf], 1, False),
        # right wall
        ([rbb, rbf, rtf], 2, False),
        ([rbb, rtf, rtb], 2, False),
        # front wall
        ([lbf, rtf, rbf], 3, False),
        ([lbf, ltf, rtf], 3, False),
        # floor
        ([lbb, rbf, rbb], 4, False),
        ([lbb, lbf, rbf], 4, False),
        # ceiling
        ([ltb, rtb, rtf], 4, False),
        ([ltb, rtf, ltf], 4, False),
        # ceiling light (box assumed origin-centered in x/z, load.py:243)
        ([ltb * shrink, rtb * shrink, rtf * shrink], 6, True),
        ([ltb * shrink, rtf * shrink, ltf * shrink], 6, True),
    ]
    soup = TriangleSoup.empty()
    for corners, mat, emit in tris:
        soup = soup + TriangleSoup.from_vertices(
            np.array([corners], dtype=np.float32), material=mat, is_light=emit
        )
    return soup


def camera_geometry(camera) -> TriangleSoup:
    """Sensor plane as two scene triangles (reference load.py:261-271).

    Required by the BDPT t=1 strategy: light subpaths are projected toward
    the focal point and must land on this geometry (trace.metal:592-596).
    """
    origin = camera.origin
    bottom = origin + camera.dx * camera.phys_width
    top = origin + camera.dx * camera.phys_width + camera.dy * camera.phys_height
    other_top = origin + camera.dy * camera.phys_height
    verts = np.array(
        [[origin, bottom, top], [origin, top, other_top]], dtype=np.float32
    )
    return TriangleSoup.from_vertices(verts, material=7, is_camera=True)
