"""The reference against the program at small sizes on the CPU: a sample
of the program's renderer, accumulated into its state, equals the
reference's sample accumulated into the same state (``compare.numbers``
reads 0 off), on the brute route and on a BVH scene in Morton order (the
order the card takes for every BVH scene)."""

import subprocess
import sys

import pytest
import torch

import clive2_tpu_torch as ct
from benchmark import compare, manifest
from benchmark.modes.progressive import reference_sample

from .helpers import blob_scene, small_cell


def _program_sample(scene, seed, warmups=2):
    r = ct.Renderer(scene, seed=seed, device="cpu")
    for _ in range(warmups):
        r.run_sample()
    before, index = r.state, r.samples
    r.run_sample()
    return before, r.state, index, r.samples


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_cornell_matches(tmp_path, seed):
    c = small_cell(width=40, height=24)
    scene = ct.create_scene_from_preset("empty", 40, 24, device="cpu")
    before, after, index, final = _program_sample(scene, seed)
    sample, _ = reference_sample(c["config"], c["traffic"], seed, index,
                                 str(tmp_path), "cpu")
    got = compare.numbers(before, after, sample, final, final)
    assert got == dict(off_share=0.0, count_gap=0.0)


def test_bvh_scene_matches_in_morton_order(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIVE2_WAVE_ORDER", "morton")
    config, scene = blob_scene(tmp_path, 36, 20)
    assert "brute" not in scene.data
    c = small_cell("sponza.1080p", width=36, height=20)
    before, after, index, final = _program_sample(scene, 2**31 + 9)
    sample, ref_scene = reference_sample(config, c["traffic"], 2**31 + 9,
                                         index, str(tmp_path), "cpu")
    assert "lbvh" in ref_scene
    got = compare.numbers(before, after, sample, final, final)
    assert got == dict(off_share=0.0, count_gap=0.0)


def test_lbvh_is_the_closest_hit(tmp_path):
    """The reference's tree walk answers as a dense test of every
    triangle, on random rays with caps, masks and any-hit."""
    from benchmark.reference.ops import brute, intersect, lbvh
    from benchmark.reference.scene import build_scene

    config, _ = blob_scene(tmp_path, 8, 8)
    scene = build_scene(config["scene"], 8, 8, str(tmp_path), "cpu")
    tree = scene["lbvh"]
    g = torch.Generator().manual_seed(0)
    n = 3000
    o = (torch.rand(n, 3, generator=g) * 2 - 1) * torch.tensor([8., 6., 8.])
    o[:, 1] += 1.0
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    active = torch.rand(n, generator=g) < 0.8
    t_max = torch.rand(n, generator=g) * 20
    ids = tree["ids"].reshape(-1)
    keep = ids >= 0
    tris = tree["tris"].reshape(-1, 9)[keep]
    table = torch.cat([tris, torch.zeros(tris.shape[0], 1)], 1)
    none = (torch.full((n,), -1, dtype=torch.int32), torch.full((n,), float(
        "inf")), torch.zeros(n), torch.zeros(n))
    want = brute.brute_plain(o, d, table, active, t_max)
    got = lbvh.intersect_lbvh(o, d, tree, none, active, t_max=t_max)
    assert torch.equal(got[0] >= 0, want[0] >= 0)
    hit = want[0] >= 0
    assert int(hit.sum()) > 100
    assert torch.equal(got[0][hit], ids[keep][want[0][hit].long()])
    assert torch.equal(got[1][hit], want[1][hit])
    anyh = lbvh.intersect_lbvh(o, d, tree, none, active, t_max=t_max,
                               any_hit=True)
    assert torch.equal(anyh[0] >= 0, hit)
    assert bool((anyh[1][hit] < t_max[hit]).all())
    assert intersect.CHUNK > 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.scene, "
            "benchmark.reference.integrator.render, benchmark.control, "
            "benchmark.compare, benchmark.meshgen; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=manifest.ROOT).stdout
    names = eval(out)
    for bad in ("clive2_tpu_torch", "clive2_tpu", "jax", "jaxlib"):
        assert bad not in names
