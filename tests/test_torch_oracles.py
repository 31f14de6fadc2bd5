"""The statistical oracles, run against the port (imports no JAX).

The port's versions of tests/test_convergence.py (Cornell 64x64, 256 spp,
8x8 blocks), test_convergence_glass.py (48x48, 256 spp), test_furnace.py
(both furnaces) and the statistical halves of test_adaptive.py and
test_chunked.py, with the same scenes, seeds, sample counts and bounds
(``clive2_tpu_torch.oracles``).  They compare the port with itself, so they
are the port's check of its MIS chain that does not depend on masking near
ties.  Marked slow, like the originals: run them on the CPU with
``python -m pytest tests/ -m slow -k torch_oracles`` (minutes), and on the
card with

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py tests/test_torch_oracles.py

The device is the card when one is present, else the CPU.
"""

import numpy as np
import pytest
import torch

import clive2_tpu_torch as ct
from clive2_tpu_torch import oracles

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.fixture(scope="module")
def convergence(device):
    r = oracles.convergence(device)
    print("convergence", r)
    return r


def test_bdpt_class_limited_matches_unidirectional_strict(convergence):
    oracles.check("convergence", convergence, only="strict")


def test_bdpt_total_vs_unidirectional_regression(convergence):
    oracles.check("convergence", convergence, only="total")


def test_glass_bdpt_class_limited_matches_unidirectional(device):
    r = oracles.glass_convergence(device)
    print("glass_convergence", r)
    assert r["brute"]
    oracles.check("glass_convergence", r)


@pytest.fixture(scope="module")
def furnace(device):
    r = oracles.furnace(device)
    print("furnace", r)
    return r


def test_furnace_direct_class_is_uniform_emission(furnace):
    oracles.check("furnace", furnace, only="class 1")


def test_furnace_class_ratios_equal_albedo(furnace):
    oracles.check("furnace", furnace, only="every class")


def test_glass_furnace_sphere_is_invisible(device):
    r = oracles.glass_furnace(device)
    print("glass_furnace", r)
    oracles.check("glass_furnace", r)


# ---- adaptive sampling and stripes (test_adaptive.py, test_chunked.py) ----

ADAPTIVE = 48


def _run(scene, seed, uniform, adaptive=0, fraction=0.25, chunk_rows=None):
    r = ct.Renderer(scene, seed=seed, chunk_rows=chunk_rows)
    for _ in range(uniform):
        r.run_sample()
    for _ in range(adaptive):
        r.run_adaptive_sample(fraction=fraction)
    return r


def test_adaptive_counts_and_consistency(device):
    scene = ct.create_scene_from_preset("empty", ADAPTIVE, ADAPTIVE,
                                        device=device)
    n = ADAPTIVE * ADAPTIVE
    uniform = _run(scene, 3, 10)
    adaptive = _run(scene, 3, 4, adaptive=24)
    counts = adaptive.state["pixel_count"].cpu().numpy()
    assert counts.min() >= 4.0
    assert counts.sum() == pytest.approx(4 * n + 24 * (n // 4), rel=1e-6)
    assert counts.max() >= counts.min() + 4     # the selection discriminates
    ratio = adaptive.raw_image.mean() / uniform.raw_image.mean()
    print("adaptive energy ratio", ratio, "counts", counts.min(),
          counts.max())
    assert 0.85 < ratio < 1.15


def test_adaptive_composes_with_chunked(device):
    scene = ct.create_scene_from_preset("empty", ADAPTIVE, ADAPTIVE,
                                        device=device)
    n = ADAPTIVE * ADAPTIVE
    # fraction 0.5: 1,152 pixels in batches of 12 * 48 = 576
    r = _run(scene, 7, 4, adaptive=6, fraction=0.5, chunk_rows=12)
    assert r.chunk_rows == 12
    counts = r.state["pixel_count"].cpu().numpy()
    assert counts.min() >= 4.0
    assert counts.sum() == pytest.approx(4 * n + 6 * (n // 2), rel=1e-6)
    assert counts.max() >= counts.min() + 2
    ratio = r.raw_image.mean() / _run(scene, 7, 7).raw_image.mean()
    print("adaptive x chunked energy ratio", ratio)
    assert 0.85 < ratio < 1.15


def test_chunked_matches_full(device):
    scene = ct.create_scene_from_preset("empty", 24, 24, device=device)
    full = _run(scene, 3, 48)
    chunked = _run(scene, 3, 48, chunk_rows=8)
    assert chunked.samples == full.samples
    assert int(chunked.state["n_samples"]) == full.samples
    state = {name: {k: r.state[k].cpu().numpy() / r.samples
                    for k in ("summed_image", "summed_weight",
                              "summed_unidirectional")}
             for name, r in (("full", full), ("chunked", chunked))}
    fi, ci = (state[k]["summed_image"] for k in ("full", "chunked"))
    assert np.isfinite(ci).all()
    energy = ci.mean() / fi.mean()
    # no seams: a dropped filter spill would dip at rows 8 and 16
    rows = (state["chunked"]["summed_weight"].mean(1)
            / np.maximum(state["full"]["summed_weight"].mean(1), 1e-9))
    uni = (state["chunked"]["summed_unidirectional"].mean()
           / state["full"]["summed_unidirectional"].mean())
    print("chunked energy", energy, "row ratio", rows.min(), rows.max(),
          "unidirectional", uni)
    assert abs(energy - 1.0) < 0.06
    assert rows.min() > 0.85 and rows.max() < 1.15
    assert abs(uni - 1.0) < 0.08
