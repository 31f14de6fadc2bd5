"""The reference against the program on a glass surface, on the CPU: the
3,000-triangle blob of ``helpers.BLOB`` in material 5 (BLUE glass: type 1,
alpha 0, a delta surface), rendered in Morton order, the order the card
takes for every BVH scene.  A sample of the program's renderer,
accumulated into its state, equals the reference's (``compare.numbers``
reads 0 off), so the transmission branch of the subpaths and the
connection's delta endpoints agree on both sides."""

import os

import numpy as np
import pytest

import clive2_tpu_torch as ct
from benchmark import compare, meshgen
from benchmark.modes.progressive import reference_sample

from .helpers import BLOB, blob_config, small_cell

GLASS_BLOB = dict(BLOB, file="glass_blob.ply", material=5)


def glass_config():
    c = blob_config()
    return dict(c, scene=dict(c["scene"], meshes=[GLASS_BLOB]))


def glass_scene(tmp_path, width, height):
    config = glass_config()
    meshgen.ensure_meshes(config, str(tmp_path))
    cam = config["scene"]["camera"]
    return config, ct.create_scene(
        pixel_width=width, pixel_height=height,
        cam_center=np.array(cam["center"]),
        cam_direction=np.array(cam["direction"]),
        file_specs=[dict(file_path=os.path.join(str(tmp_path),
                                                GLASS_BLOB["file"]),
                         material=GLASS_BLOB["material"],
                         scale=GLASS_BLOB["scale"],
                         offset=np.array(GLASS_BLOB["offset"]))],
        device="cpu")


@pytest.mark.parametrize("seed", [2**31 + 9, 17])
def test_glass_blob_matches_in_morton_order(tmp_path, monkeypatch, seed):
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "morton")
    config, scene = glass_scene(tmp_path, 36, 20)
    assert "brute" not in scene.data
    assert int(scene.data["mat"]["type"][GLASS_BLOB["material"]]) == 1
    c = small_cell("dragon.1080p", width=36, height=20)
    r = ct.Renderer(scene, seed=seed, device="cpu")
    for _ in range(2):
        r.run_sample()
    before, index = r.state, r.samples
    r.run_sample()
    after, final = r.state, r.samples
    sample, ref_scene = reference_sample(config, c["traffic"], seed, index,
                                         str(tmp_path), "cpu")
    assert "lbvh" in ref_scene
    got = compare.numbers(before, after, sample, final, final)
    assert got == dict(off_share=0.0, count_gap=0.0)
    # the glass is seen: the sample is not the diffuse blob's
    assert float(sample["image"].abs().sum()) > 0
