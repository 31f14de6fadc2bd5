"""Frozen copy of the turntable camera, ``orbit_camera`` of
clive2_tpu_torch/scene.py (upstream Clive2's movie orbit, src/scene.py:
frame f of n on a circle of radius 7.5 at height 1.5, looking at the
axis), as the reference's ``Camera`` and as a scene description whose
camera it replaces (``scene.build_scene`` reads that)."""

from __future__ import annotations

import numpy as np

from .camera import Camera


def orbit_center_direction(frame_idx: int, total_frames: int):
    """The camera's center and direction of frame ``frame_idx``."""
    theta = 2 * np.pi * frame_idx / total_frames
    center = np.array([np.sin(theta) * 7.5, 1.5, np.cos(theta) * 7.5])
    direction = np.array([-np.sin(theta), 0, -np.cos(theta)])
    return center, direction


def orbit_camera(frame_idx: int, total_frames: int, pixel_width: int,
                 pixel_height: int) -> Camera:
    center, direction = orbit_center_direction(frame_idx, total_frames)
    return Camera(center=center, direction=direction,
                  pixel_width=pixel_width, pixel_height=pixel_height,
                  phys_width=pixel_width / pixel_height, phys_height=1.0)


def orbit_scene(desc: dict, frame_idx: int, total_frames: int) -> dict:
    """The scene description ``desc`` seen from frame ``frame_idx``'s
    camera in place of its own."""
    center, direction = orbit_center_direction(frame_idx, total_frames)
    return dict(desc, camera=dict(center=center.tolist(),
                                  direction=direction.tolist()))
