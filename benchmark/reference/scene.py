"""The reference's scene: the tables the integrator reads, worked out again
from a configuration's scene description (frozen copy of the assembly in
clive2_tpu_torch/scene.py: the camera, the sensor plane, the Cornell-style
room, the mesh files, the per-triangle attributes and the lights, in the
program's triangle order), with the reference's own acceleration structure
in place of the program's BVH and traversal tables.

A scene of at most ``MAX_TRIS`` triangles keeps every triangle in one dense
``brute`` table, as the program does.  Any other keeps the sensor plane as
``camtri``, the room and its light as ``dense`` and the mesh files'
triangles in an ``lbvh`` (``ops/lbvh.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .camera import Camera
from .geometry import box_geometry, camera_geometry
from .load import load_mesh_file
from .materials import default_materials
from .ops.brute import MAX_TRIS, pack_brute
from .ops.lbvh import build_lbvh


def to_device(tree, device):
    """numpy leaves of a nested dict -> tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def camera_tables(camera: Camera):
    """The camera as f32 arrays (scalars as 0-d arrays)."""
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in camera.to_pytree().items()}


def make_camera(desc, width: int, height: int) -> Camera:
    cam = desc["camera"]
    return Camera(
        center=np.asarray(cam["center"], dtype=np.float64),
        direction=np.asarray(cam["direction"], dtype=np.float64),
        pixel_width=width,
        pixel_height=height,
        phys_width=width / height,
        phys_height=1.0,
    )


def build_scene(desc, width: int, height: int, resource_dir: str, device):
    """The scene tables of ``desc`` (a configuration's ``scene``: its
    ``camera`` and ``meshes``, each mesh a ``file`` under
    ``resource_dir`` with its ``material``, ``scale`` and ``offset``) at
    ``width`` x ``height``, on ``device``."""
    camera = make_camera(desc, width, height)
    materials = default_materials()
    soup = camera_geometry(camera) + box_geometry()
    n_room = len(soup)
    for mesh in desc.get("meshes", []):
        soup = soup + load_mesh_file(
            os.path.join(resource_dir, mesh["file"]),
            material=mesh.get("material", 0),
            scale=mesh.get("scale", 1.0),
            offset=np.asarray(mesh.get("offset", (0.0, 0.0, 0.0)),
                              dtype=np.float64))

    tri = dict(
        face_normal=soup.face_normals,
        n0=soup.vertex_normals[:, 0],
        n1=soup.vertex_normals[:, 1],
        n2=soup.vertex_normals[:, 2],
        material=soup.material.astype(np.int32),
        is_light=soup.is_light.astype(np.int32),
        is_camera=soup.is_camera.astype(np.int32),
    )
    packed_attrs = np.zeros((len(soup), 16), dtype=np.float32)
    packed_attrs[:, 0:3] = soup.face_normals
    packed_attrs[:, 3:6] = soup.vertex_normals[:, 0]
    packed_attrs[:, 6:9] = soup.vertex_normals[:, 1]
    packed_attrs[:, 9:12] = soup.vertex_normals[:, 2]
    packed_attrs[:, 12] = soup.material
    packed_attrs[:, 13] = soup.is_light
    packed_attrs[:, 14] = soup.is_camera
    tri["packed"] = packed_attrs

    light_sel = np.nonzero(soup.is_light)[0]
    areas = soup.surface_areas()[light_sel]
    lights = dict(
        v0=soup.vertices[light_sel, 0],
        v1=soup.vertices[light_sel, 1],
        v2=soup.vertices[light_sel, 2],
        normal=soup.face_normals[light_sel],
        area=areas.astype(np.float32),
        tri_index=light_sel.astype(np.int32),
        material=soup.material[light_sel].astype(np.int32),
    )
    data = dict(tri=tri, mat=materials.to_pytree(), lights=lights,
                camera=camera_tables(camera))
    if len(soup) <= MAX_TRIS:
        data["brute"] = dict(tris=pack_brute(soup))
        return to_device(data, device)

    v = soup.vertices
    edges = lambda sel: dict(v0=v[sel, 0], e1=v[sel, 1] - v[sel, 0],
                             e2=v[sel, 2] - v[sel, 0])
    cam_ids = np.nonzero(soup.is_camera)[0]
    room = np.array([i for i in range(n_room) if not soup.is_camera[i]])
    meshes = np.arange(n_room, len(soup))
    data["camtri"] = dict(edges(cam_ids), ids=cam_ids.astype(np.int32))
    dense = pack_brute(soup.select(room))
    data["dense"] = dict(tris=dense, ids=room.astype(np.int64))
    data = to_device(data, device)
    mesh_tris = edges(meshes)
    data["lbvh"] = build_lbvh(mesh_tris["v0"], mesh_tris["e1"],
                              mesh_tris["e2"], meshes, device)
    return data

