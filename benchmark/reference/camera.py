"""Frozen copy of clive2_tpu_torch/camera.py.

Physical-plane camera model and Reinhard tone mapping.

Rebuild of the reference camera (reference src/camera.py:7-86).  The
camera sensor is a physical rectangle in the scene: rays start on the plane
and travel toward a focal point ``focal_dist`` in front of the plane center.
The sensor also exists as geometry (two triangles, see geometry.py) so light
subpaths can splat onto it (the BDPT t=1 strategy).

Instead of the reference's packed ``Camera`` struct (struct_types.py:70-85)
we expose a pytree of arrays consumable directly by jitted code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .constants import H_FOV, UNIT_X, UNIT_Y, UNIT_Z


@dataclasses.dataclass
class Camera:
    center: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = dataclasses.field(default_factory=lambda: UNIT_X.copy())
    phys_width: float = 1.0
    phys_height: float = 1.0
    pixel_width: int = 1280
    pixel_height: int = 720

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64)
        self.direction = np.asarray(self.direction, dtype=np.float64)
        self.aspect_ratio = self.phys_width / self.phys_height
        self.h_fov = H_FOV
        self.v_fov = 2.0 * np.arctan(np.tan(H_FOV / 2.0) / self.aspect_ratio)
        # sensor-plane basis and lower corner (reference camera.py:27-31)
        self.dx_dp = self.dx * self.phys_width / self.pixel_width
        self.dy_dp = self.dy * self.phys_height / self.pixel_height
        self.pixel_phys_size = float(
            np.linalg.norm(self.dx_dp) * np.linalg.norm(self.dy_dp)
        )
        self.origin = (
            self.center
            - self.dx * self.phys_width / 2
            - self.dy * self.phys_height / 2
        )

    @property
    def focal_dist(self) -> float:
        return self.phys_width / (2 * np.tan(self.h_fov / 2))

    @property
    def focal_point(self) -> np.ndarray:
        return self.center + self.focal_dist * self.direction

    @property
    def dx(self) -> np.ndarray:
        # reference camera.py:42-48
        if abs(self.direction[0]) < 0.0001:
            return UNIT_X if self.direction[2] > 0 else UNIT_X * -1
        dx = np.cross(self.direction * (UNIT_X + UNIT_Z), UNIT_Y * -1)
        return dx / np.linalg.norm(dx)

    @property
    def dy(self) -> np.ndarray:
        # reference camera.py:50-55
        if abs(self.direction[1]) < 0.0001:
            return UNIT_Y
        dy = np.cross(self.direction, self.dx)
        return dy / np.linalg.norm(dy)

    def to_pytree(self) -> Dict[str, Any]:
        """Device-consumable dict of f32/i32 arrays (the jit-traced camera).

        Replaces the reference's byte-matched struct upload
        (camera.py:57-70); pixel counts stay host ints (static shapes).
        """
        f32 = lambda v: np.asarray(v, dtype=np.float32)
        return dict(
            center=f32(self.center),
            focal_point=f32(self.focal_point),
            direction=f32(self.direction),
            dx=f32(self.dx),
            dy=f32(self.dy),
            phys_width=np.float32(self.phys_width),
            phys_height=np.float32(self.phys_height),
        )


def tone_map(image: np.ndarray, exposure: float = 2.0, white_point: float = 1.0) -> np.ndarray:
    """Log-average-luminance Reinhard tone map (reference camera.py:73-82).

    ``image`` is float BGR; returns uint8 BGR.
    """
    image = np.asarray(image)
    tone_vector = np.array([0.0722, 0.7152, 0.2126])  # BGR luma
    tone_sums = np.sum(image * tone_vector, axis=2)
    log_tone_sums = np.log(0.1 + tone_sums)
    per_pixel_lts = np.sum(log_tone_sums) / np.prod(image.shape[:2])
    Lw = np.exp(per_pixel_lts)
    result = image * exposure / Lw
    return (255 * result / (result + white_point**2)).astype(np.uint8)


def basic_tone_map(image: np.ndarray) -> np.ndarray:
    """Parity with reference camera.py:85-86."""
    return (255 * np.sqrt(image) / image).astype(np.uint8)
