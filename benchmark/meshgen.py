"""Writes the procedural meshes the configurations read, with the
benchmark's frozen copy of the program's generator (``reference/
primitives.py``, ``reference/load.py:write_ply``), into a fixed folder of
the checkout that the harness hands to the program as ``CLIVE2_RESOURCES``
and that the reference reads too.  A mesh is written once per checkout: a
file that is there is kept.

A configuration's mesh names its generator: ``displaced_blob_exact`` with
its ``triangles``, placed as the program's ``make_assets`` places it
(``vertices * 0.06 + (0, 0.085, 0)``, binary PLY).
"""

from __future__ import annotations

import os

import numpy as np

from .reference.load import write_ply
from .reference.primitives import displaced_blob_exact

GENERATORS = ("displaced_blob_exact",)


def write_mesh(path: str, generator: dict) -> None:
    """Write the mesh ``generator`` describes to ``path`` (atomically: a run
    cut short leaves no partial file under the name)."""
    if generator.get("kind") not in GENERATORS:
        raise ValueError(f"unknown mesh generator {generator!r}")
    v, f = displaced_blob_exact(int(generator["triangles"]))
    tmp = path + ".part"
    write_ply(tmp, v * 0.06 + np.array([0.0, 0.085, 0.0]), f, binary=True)
    os.replace(tmp, path)


def ensure_meshes(config: dict, directory: str) -> dict:
    """Write the meshes of ``config`` missing from ``directory``.  Returns
    {file: True when it was written now}."""
    os.makedirs(directory, exist_ok=True)
    out = {}
    for mesh in config["scene"].get("meshes", []):
        path = os.path.join(directory, mesh["file"])
        out[mesh["file"]] = not os.path.exists(path)
        if out[mesh["file"]]:
            write_mesh(path, mesh["generator"])
    return out
