"""Frozen copy of clive2_tpu_torch/materials.py.

Material table as SoA arrays.

Rebuild of the reference's 8-slot hard-coded table
(reference src/load.py:179-200) plus a small builder API so users can
define their own.  Material semantics (trace.metal:474-487):

    type 0 — diffuse (cosine-weighted Lambert)
    type 1 — Fresnel-weighted GGX reflect | transmit (glass)
    type 2 — Fresnel-weighted GGX reflect | diffuse (glossy)
    type 3+ (else) — pure GGX mirror

``alpha`` is GGX roughness (0 = perfect specular delta, GGX_D convention at
trace.metal:280), ``ior`` the refractive index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import BLUE, FULL_WHITE, GREEN, RED, WHITE

DIFFUSE = 0
GLASS = 1
GLOSSY = 2
MIRROR = 3

CAMERA_MATERIAL = 7  # slot used by the sensor-plane geometry


@dataclasses.dataclass
class MaterialTable:
    color: np.ndarray     # [M, 3] f32, BGR
    emission: np.ndarray  # [M, 3] f32
    type: np.ndarray      # [M]   i32
    alpha: np.ndarray     # [M]   f32
    ior: np.ndarray       # [M]   f32

    def __len__(self) -> int:
        return int(self.color.shape[0])

    def to_pytree(self):
        return dataclasses.asdict(self)

    def append(self, spec: dict) -> int:
        """Append one material (schema as in :meth:`build`); returns its
        slot index.  Used by scene.create_scene for per-file
        ``material_def`` overrides."""
        new = MaterialTable.build([spec])
        idx = len(self)
        self.color = np.concatenate([self.color, new.color])
        self.emission = np.concatenate([self.emission, new.emission])
        self.type = np.concatenate([self.type, new.type])
        self.alpha = np.concatenate([self.alpha, new.alpha])
        self.ior = np.concatenate([self.ior, new.ior])
        return idx

    @classmethod
    def build(cls, specs) -> "MaterialTable":
        """specs: iterable of dicts with color/emission/type/alpha/ior."""
        m = len(specs)
        t = cls(
            color=np.zeros((m, 3), np.float32),
            emission=np.zeros((m, 3), np.float32),
            type=np.zeros((m,), np.int32),
            alpha=np.zeros((m,), np.float32),
            ior=np.ones((m,), np.float32),
        )
        for i, s in enumerate(specs):
            t.color[i] = s.get("color", FULL_WHITE)
            t.emission[i] = s.get("emission", (0, 0, 0))
            t.type[i] = s.get("type", DIFFUSE)
            t.alpha[i] = s.get("alpha", 0.0)
            t.ior[i] = s.get("ior", 1.5)
        return t


def default_materials() -> MaterialTable:
    """The reference's 8-slot table (load.py:179-200).

    Slot 0 RED glass, 1 GREEN diffuse, 2 BLUE diffuse, 3/4 WHITE diffuse,
    5 BLUE glass, 6 white emitter, 7 camera-plane material.
    """
    return MaterialTable.build(
        [
            dict(color=RED, type=GLASS),
            dict(color=GREEN),
            dict(color=BLUE),
            dict(color=WHITE),
            dict(color=WHITE),
            dict(color=BLUE, type=GLASS),
            dict(color=FULL_WHITE, emission=(1.0, 1.0, 1.0)),
            dict(color=FULL_WHITE),
        ]
    )
