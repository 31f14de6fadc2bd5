"""On the card (skipped without one): a small ``dragon.1080p`` cell, the
glass dragon at 96x54, through the harness: its scene takes the BVH2
route (a ``bvh2`` table, no ``brute`` or ``stream2`` table) and the run
is ``correct``."""

import os

import pytest

from benchmark import run

from .helpers import args, small_cell


@pytest.mark.cuda
def test_small_dragon_on_the_card(card, tmp_path, monkeypatch):
    import clive2_tpu_torch as ct
    from clive2_tpu_torch.scene import scene_presets

    # the preset reads its mesh where the harness writes it
    spec = scene_presets["dragon"]["file_specs"][0]
    monkeypatch.setitem(spec, "file_path", os.path.join(
        str(tmp_path), os.path.basename(spec["file_path"])))
    scenes = []

    def keep(*a, _fn=ct.create_scene_from_preset, **k):
        scenes.append(_fn(*a, **k))
        return scenes[-1]

    monkeypatch.setattr(ct, "create_scene_from_preset", keep)
    c = small_cell("dragon.1080p", width=96, height=54)
    r = run.run(c, args("dragon.1080p", seconds=2.0), device=str(card),
                resources=str(tmp_path))
    data = scenes[0].data
    assert "bvh2" in data
    assert "brute" not in data and "stream2" not in data
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert r["metrics"]["s_per_sample"]["value"] > 0
