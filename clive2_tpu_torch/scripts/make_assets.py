"""Generate the meshes the scene presets read (the port's counterpart of
the JAX package's scripts/make_assets.py: the same five files, byte for
byte, and the same prints).

    python -m clive2_tpu_torch.scripts.make_assets

Writes into ``CLIVE2_RESOURCES`` or the checkout's ``resources/``.  The
teapot is the exact Utah teapot (``models.utah_teapot(n=10)``, 6,320
triangles, the mesh the reference's teapot.obj holds); the dragons and the
Sponza-scale mesh are procedural stand-ins (``models.displaced_blob_exact``)
at the real triangle counts, scaled to the presets' footprint (the presets
apply scale 50 and offset (0, -4, 0); the real dragon spans about 0.15
units).  Host only: nothing runs on a device.
"""

from __future__ import annotations

import os

import numpy as np

from ..load import write_obj, write_ply
from ..models import displaced_blob_exact, utah_teapot
from ..scene import RESOURCE_DIR

# each file and the triangle count its stand-in is sized to (None: the
# teapot); sponza_scale.ply is the "Sponza-scale ~1M tris" stand-in
MESHES = (("teapot.obj", None),
          ("dragon_vrip_res3.ply", 47_794),
          ("dragon_vrip_res2.ply", 202_520),
          ("dragon_vrip.ply", 871_414),
          ("sponza_scale.ply", 1_310_720))


def write_mesh(directory: str, name: str) -> int:
    """Write mesh ``name`` of ``MESHES`` into ``directory``; returns its
    triangle count."""
    count = dict(MESHES)[name]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    if count is None:
        v, f = utah_teapot(n=10)
        write_obj(path, v, f)
    else:
        v, f = displaced_blob_exact(count)
        write_ply(path, v * 0.06 + np.array([0.0, 0.085, 0.0]), f,
                  binary=True)
    return len(f)


def main(directory=RESOURCE_DIR):
    for name, count in MESHES:
        tris = write_mesh(directory, name)
        note = " (exact Utah teapot)" if count is None else ""
        print(f"{name}: {tris} tris{note}")


if __name__ == "__main__":
    main()
