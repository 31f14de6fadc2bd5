"""Every configuration describes its preset's scene: the camera, and each
mesh's file, material, scale and offset in ``configs/<name>.json`` equal
the program's ``scene_presets`` entry that its ``preset`` names, so the
reference renders the scene the program renders."""

import os

import numpy as np
import pytest

from benchmark import manifest
from clive2_tpu_torch.scene import scene_presets

M = manifest.load_manifest()


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_the_scene_is_the_preset(name):
    c = next(w for w in M["workloads"] if w["config"] == name)
    config = manifest.cell(M, c["name"])["config"]
    preset = scene_presets[config["preset"]]
    scene = config["scene"]
    assert np.array_equal(np.asarray(scene["camera"]["center"], float),
                          np.asarray(preset["cam_center"], float))
    assert np.array_equal(np.asarray(scene["camera"]["direction"], float),
                          np.asarray(preset["cam_direction"], float))
    specs = preset.get("file_specs", [])
    assert len(scene["meshes"]) == len(specs)
    for mesh, spec in zip(scene["meshes"], specs):
        assert mesh["file"] == os.path.basename(spec["file_path"])
        assert mesh["material"] == spec.get("material", 0)
        assert float(mesh["scale"]) == float(spec.get("scale", 1.0))
        assert np.array_equal(np.asarray(mesh["offset"], float),
                              np.asarray(spec.get("offset", (0, 0, 0)),
                                         float))
