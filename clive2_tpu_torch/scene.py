"""Scene construction: geometry assembly, BVH build, device upload, presets
(port of clive2_tpu/scene.py).

The camera plane and the Cornell-style room are always injected, mesh files
are merged, and the BVH is built on the host; a camera move
(``Scene.with_camera``, ``orbit_camera``) swaps the sensor-plane rows and
keeps the BVH.  The result is a dict of
tensors on the requested device.  Which intersection tables a scene gets
depends on its size and on that device:

* at most 256 triangles: the ``brute`` table (CPU: the plain dense test;
  CUDA: the brute kernel);
* otherwise the gather walk's tables (``bvh``), the sensor-plane
  triangles (``camtri``) and one traversal's tables (``traversal_tables``):
  by default scenes of at least ``STREAM2_MIN_TRIS`` world triangles get
  the fat-leaf traversal's ``stream2`` (on the CPU its plain version, on
  CUDA its kernel); smaller ones get, on CUDA, the BVH2 kernel's ``bvh2``
  (on the CPU they take the gather walk).  ``CLIVE2_TRAVERSAL`` and
  ``CLIVE2_STREAM_IMPL`` select the others as the JAX package does
  (``selected_traversal``): the BVH8 kernel's ``wide`` and the streaming
  kernel's ``stream``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .bvh import build_bvh
from .bvh.build import leaf_tables
from .camera import Camera
from .constants import UNIT_Z, ZERO_VECTOR
from .geometry import TriangleSoup, box_geometry, camera_geometry
from .load import load_mesh_file
from .materials import MaterialTable, default_materials
from .ops.brute import MAX_TRIS as BRUTE_FORCE_MAX_TRIS
from .ops.brute import pack_brute
from .ops.intersect import pack_gather_walk
from .ops.traverse_bvh2 import pack_bvh2
from .ops.traverse_stream import pack_stream
from .ops.traverse_stream2 import pack_stream2
from .ops.traverse_wide import pack_bvh8

RESOURCE_DIR = os.environ.get(
    "CLIVE2_RESOURCES",
    os.path.join(os.path.dirname(__file__), "..", "resources"),
)

# world triangle count from which a scene takes the fat-leaf traversal: the
# JAX package's packet-kernel ceiling (clive2_tpu/scene.py:37-39)
STREAM2_MIN_TRIS = 100_000

# CLIVE2_TRAVERSAL's values ("" = unset) and each traversal table's packer
TRAVERSALS = ("", "wide", "pallas2", "stream")
PACKERS = dict(wide=pack_bvh8, bvh2=pack_bvh2, stream=pack_stream,
               stream2=pack_stream2)


@dataclasses.dataclass
class Scene:
    """Host handle + device tensors for one renderable scene."""

    camera: Camera
    pixel_width: int
    pixel_height: int
    data: Dict[str, Any]          # dict of tensors on ``device``
    n_triangles: int
    n_nodes: int
    device: torch.device
    camera_tri_ids: Any = None    # global ids of the sensor-plane triangles
    build_seconds: float = 0.0    # host build and upload of the tables

    def with_camera(self, camera: Camera) -> "Scene":
        """This scene seen from ``camera``: only the camera and the
        sensor-plane triangles change, no BVH is rebuilt (the reference
        rebuilds the whole scene every animation frame).

        The sensor plane lives outside the BVH: BVH scenes intersect it as
        ``camtri``, brute scenes keep it in their triangle table.  Its rows
        are swapped at ``camera_tri_ids`` in copies of the tables that hold
        them (the camera, ``camtri`` or the brute table, and the triangle
        attributes ``face_normal``, ``n0``-``n2`` and ``packed``); every
        other table is shared with this scene, which is left unchanged.
        """
        cam_soup = camera_geometry(camera)
        ids = np.asarray(self.camera_tri_ids)
        if len(cam_soup) != len(ids):
            raise ValueError(f"the new sensor has {len(cam_soup)} "
                             f"triangles, the scene {len(ids)}")
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                      device=dev)
        # f32 first, then the edges, as the JAX package's swap computes them
        v = cam_soup.vertices.astype(np.float32)
        v0, e1, e2 = t(v[:, 0]), t(v[:, 1] - v[:, 0]), t(v[:, 2] - v[:, 0])
        fn, vn = t(cam_soup.face_normals), t(cam_soup.vertex_normals)
        rows = torch.as_tensor(ids, dtype=torch.int64, device=dev)

        data = dict(self.data)
        data["camera"] = to_device(camera_tables(camera), dev)
        if "camtri" in data:
            data["camtri"] = dict(v0=v0, e1=e1, e2=e2, ids=rows.to(
                torch.int32))
        if "brute" in data:
            tris = data["brute"]["tris"].clone()
            tris[rows, 0:3] = v0
            tris[rows, 3:6] = e1
            tris[rows, 6:9] = e2
            data["brute"] = dict(data["brute"], tris=tris)
        tri = dict(data["tri"])
        for k, val in (("face_normal", fn), ("n0", vn[:, 0]),
                       ("n1", vn[:, 1]), ("n2", vn[:, 2])):
            tri[k] = tri[k].clone()
            tri[k][rows] = val
        packed = tri["packed"].clone()
        packed[rows, 0:3] = fn
        for col, k in enumerate(range(3, 12, 3)):
            packed[rows, k:k + 3] = vn[:, col]
        tri["packed"] = packed
        data["tri"] = tri
        return dataclasses.replace(
            self, camera=camera, data=data, pixel_width=camera.pixel_width,
            pixel_height=camera.pixel_height, build_seconds=0.0)


def to_device(tree, device):
    """numpy leaves of a nested dict -> tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def camera_tables(camera: Camera):
    """The camera as f32 arrays (scalars as 0-d arrays)."""
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in camera.to_pytree().items()}


def camtri_arrays(cam_soup, ids):
    v = cam_soup.vertices
    return dict(v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0],
                ids=np.asarray(ids, dtype=np.int32))


def selected_traversal(n_world: int, cuda: bool) -> Optional[str]:
    """The traversal table a BVH scene with ``n_world`` triangles in its
    tree takes, by the JAX package's selectors (clive2_tpu/scene.py:263-372):

    * ``CLIVE2_TRAVERSAL=wide``: ``wide`` at any size;
    * ``CLIVE2_TRAVERSAL=pallas2``: ``bvh2`` at any size on CUDA (the CPU
      takes the gather walk: None);
    * ``CLIVE2_TRAVERSAL=stream``: a streaming table at any size the cut
      accepts;
    * unset: a streaming table from ``STREAM2_MIN_TRIS`` world triangles,
      else ``bvh2`` on CUDA and the gather walk on the CPU.

    A streaming table is ``stream`` under ``CLIVE2_STREAM_IMPL=1``, else
    ``stream2``.  Unlike the JAX package, ``CLIVE2_STREAM_IMPL=1`` needs no
    ``CLIVE2_STREAM1_FORCE`` (that fence guards a TPU fault), and an
    unknown ``CLIVE2_TRAVERSAL`` raises instead of taking the streaming
    path.
    """
    force = os.environ.get("CLIVE2_TRAVERSAL", "")
    if force not in TRAVERSALS:
        raise ValueError(f"CLIVE2_TRAVERSAL={force!r}: expected one of "
                         f"{', '.join(t for t in TRAVERSALS if t)} or unset")
    if force == "wide":
        return "wide"
    if force == "stream" or (not force and n_world >= STREAM2_MIN_TRIS):
        impl = os.environ.get("CLIVE2_STREAM_IMPL") or "2"
        return "stream" if impl == "1" else "stream2"
    return "bvh2" if cuda else None


def traversal_tables(bvh_rows, n_world: int, cuda: bool,
                     traversal: Optional[str] = None):
    """The traversal tables of a BVH scene with ``n_world`` triangles in
    its tree, packed from the gather walk's rows ``bvh_rows``: those of
    ``traversal`` (``wide``, ``bvh2``, ``stream`` or ``stream2``) when it
    is given, else of ``selected_traversal``.  Beside them the table keeps
    the root box, ``lo``/``hi`` (the JAX packers' ``node_mins[0]`` /
    ``node_maxes[0]``), which keys its casts' Morton sort."""
    traversal = traversal or selected_traversal(n_world, cuda)
    if traversal is None:
        return {}
    rows = (np.asarray(bvh_rows["node_packed"]),
            np.asarray(bvh_rows["leaf_packed"]))
    tables = PACKERS[traversal](*rows)
    tables.update(lo=rows[0][0, 0:3].astype(np.float32),
                  hi=rows[0][0, 3:6].astype(np.float32))
    return {traversal: tables}


def _build_scene_arrays(soup: TriangleSoup, materials: MaterialTable,
                        camera: Camera, cuda: bool):
    """numpy scene tables.  The sensor plane stays out of the BVH; brute
    scenes keep it in their dense triangle table."""
    cam_ids = np.nonzero(soup.is_camera)[0]
    world_sel = np.nonzero(~soup.is_camera)[0]
    world = soup.select(world_sel)

    bvh = build_bvh(world)
    leafs = leaf_tables(bvh, world)
    # leaf tri ids are world-local; remap to global soup ids
    leafs["tri_index"] = np.where(
        leafs["tri_index"] >= 0,
        world_sel[np.minimum(leafs["tri_index"], len(world) - 1)],
        -1,
    ).astype(np.int32)

    tri = dict(
        face_normal=soup.face_normals,
        n0=soup.vertex_normals[:, 0],
        n1=soup.vertex_normals[:, 1],
        n2=soup.vertex_normals[:, 2],
        material=soup.material.astype(np.int32),
        is_light=soup.is_light.astype(np.int32),
        is_camera=soup.is_camera.astype(np.int32),
    )
    # every hit-shading attribute in one row: one gather per bounce
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
    data = dict(
        tri=tri,
        bvh=pack_gather_walk(bvh, leafs),
        mat=materials.to_pytree(),
        lights=lights,
        camera=camera_tables(camera),
    )
    if len(soup) <= BRUTE_FORCE_MAX_TRIS:
        data["brute"] = dict(tris=pack_brute(soup))
    else:
        data["camtri"] = camtri_arrays(soup.select(cam_ids), cam_ids)
        data.update(traversal_tables(data["bvh"], len(world), cuda))
    return data, bvh, cam_ids


def create_scene(
    pixel_width: int = 1280,
    pixel_height: int = 720,
    cam_center=ZERO_VECTOR,
    cam_direction=UNIT_Z,
    file_specs=None,
    materials: Optional[MaterialTable] = None,
    extra_geometry: Optional[TriangleSoup] = None,
    box_kwargs: Optional[dict] = None,
    soup_transform=None,
    device="cuda",
) -> Scene:
    """Assemble a scene on ``device`` (the card unless the caller asks for
    the CPU; raises when ``device`` is CUDA and there is no card).

    Always injects the camera-plane triangles and the Cornell-style room
    with its ceiling light, then merges any mesh files from ``file_specs``
    (file_path / material / material_def / scale / offset).
    ``soup_transform`` may re-flag or re-material the assembled soup before
    the BVH build.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    camera = Camera(
        center=np.asarray(cam_center, dtype=np.float64),
        direction=np.asarray(cam_direction, dtype=np.float64),
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        phys_width=pixel_width / pixel_height,
        phys_height=1.0,
    )
    materials = materials or default_materials()
    if any("material_def" in s for s in file_specs or []):
        # appending must not mutate a caller-owned table
        materials = dataclasses.replace(
            materials, **{k: v.copy() for k, v in
                          materials.to_pytree().items()}
        )
    soup = camera_geometry(camera) + box_geometry(**(box_kwargs or {}))
    if extra_geometry is not None:
        soup = soup + extra_geometry
    for spec in file_specs or []:
        mat_idx = spec.get("material", 0)
        if "material_def" in spec:
            mat_idx = materials.append(spec["material_def"])
        soup = soup + load_mesh_file(
            spec["file_path"],
            material=mat_idx,
            scale=spec.get("scale", 1.0),
            offset=spec.get("offset", ZERO_VECTOR),
        )

    if soup_transform is not None:
        soup = soup_transform(soup)

    t0 = time.perf_counter()
    data, bvh, cam_ids = _build_scene_arrays(soup, materials, camera,
                                             cuda=device.type == "cuda")
    data = to_device(data, device)
    return Scene(
        camera=camera,
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        data=data,
        n_triangles=len(soup),
        n_nodes=bvh.n_nodes,
        device=device,
        camera_tri_ids=cam_ids,
        build_seconds=time.perf_counter() - t0,
    )


# presets (names and parameters match the JAX package's scene.py)

def _res(name: str) -> str:
    return os.path.join(RESOURCE_DIR, name)


scene_presets: Dict[str, dict] = {
    "empty": {
        "cam_center": np.array([0, 1.5, 6]),
        "cam_direction": np.array([0, 0, -1]),
    },
    "teapots": {
        "cam_center": np.array([7, 0, 8]),
        "cam_direction": np.array([-1, 0, -1]),
        "file_specs": [
            {"file_path": _res("teapot.obj"), "offset": np.array([0, 0, 2.5]),
             "material": 5},
            {"file_path": _res("teapot.obj"), "offset": np.array([0, 0, -2.5]),
             "material": 0},
        ],
    },
    "dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip_res3.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    "medium-dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip_res2.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    "big-dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    "sponza": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("sponza_scale.ply"),
             "offset": np.array([0, -4, 0]), "material": 4, "scale": 50},
        ],
    },
}


def create_scene_from_preset(preset_name: str, pixel_width=1280,
                             pixel_height=720, device="cuda") -> Scene:
    """``create_scene`` with a preset's camera and meshes, on ``device``
    (the card unless the caller asks for the CPU)."""
    preset = scene_presets.get(preset_name)
    if not preset:
        raise ValueError(f"Preset '{preset_name}' not found.")
    return create_scene(
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        cam_center=preset["cam_center"],
        cam_direction=preset["cam_direction"],
        file_specs=preset.get("file_specs"),
        device=device,
    )


def orbit_camera(frame_idx: int, total_frames: int, pixel_width: int,
                 pixel_height: int) -> Camera:
    """The turntable camera of frame ``frame_idx`` of ``total_frames``, on
    the reference's circle of radius 7.5 at height 1.5, looking at the
    axis."""
    theta = 2 * np.pi * frame_idx / total_frames
    return Camera(
        center=np.array([np.sin(theta) * 7.5, 1.5, np.cos(theta) * 7.5]),
        direction=np.array([-np.sin(theta), 0, -np.cos(theta)]),
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        phys_width=pixel_width / pixel_height,
        phys_height=1.0,
    )


def create_scene_from_preset_with_params(
    preset_name: str, pixel_width=1280, pixel_height=720,
    frame_idx: int = 0, total_frames: int = 1, device="cuda",
) -> Scene:
    """A preset's meshes seen from ``orbit_camera(frame_idx,
    total_frames)``, on ``device`` (the card unless the caller asks for the
    CPU)."""
    preset = scene_presets.get(preset_name)
    if not preset:
        raise ValueError(f"Preset '{preset_name}' not found.")
    cam = orbit_camera(frame_idx, total_frames, pixel_width, pixel_height)
    return create_scene(
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        cam_center=cam.center,
        cam_direction=cam.direction,
        file_specs=preset.get("file_specs"),
        device=device,
    )
