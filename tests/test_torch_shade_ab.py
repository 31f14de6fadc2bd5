"""The port's shading-lobe A/B (clive2_tpu_torch/scripts/shade_ab.py)
against the JAX package's scripts/shade_ab.py on the CPU.

* The three variants (all lobes and the select, diffuse only, reflect only)
  on the same inputs made with numpy from a seed, at the script's
  distributions: directions within rtol 1e-5 / atol 1e-5 on every lane;
  f and the two pdfs within rtol 1e-5 / atol 1e-6 on at least 99% of the
  lanes and within rtol 2e-3 on every lane.  XLA contracts multiplies and
  adds into FMAs and has its own transcendentals; GGX's distribution and
  its half-vector Jacobians amplify those ulps where m.n is near 1 or m.o
  near 0 (measured: rel 9e-4 at worst, on 0.5% of 16,384 lanes).
* ``make_inputs`` draws the script's distributions, the same ones for the
  same seed.
* The CLI exits 0 with ``--device cpu`` and prints its JSON line; without a
  card its default raises.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu_torch.scripts import shade_ab

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 14


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_shade_ab", os.path.join(ROOT, "scripts", "shade_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(5)
    nrm = _unit(g.normal(size=(N, 3)))
    wi = _unit(g.normal(size=(N, 3)))
    wi = np.where((wi * nrm).sum(-1, keepdims=True) < 0, -wi, wi)
    return dict(nrm=nrm, wi=wi,
                roll_a=g.random((N, 2), np.float32),
                roll_b=g.random((N, 2), np.float32),
                roll_c=g.random(N, np.float32),
                mat_type=g.integers(0, 3, N).astype(np.int32),
                alpha=np.full(N, 0.2, np.float32),
                ni=np.ones(N, np.float32), no=np.full(N, 1.5, np.float32))


@pytest.mark.parametrize("variant", ["all_lobes", "diffuse", "reflect"])
def test_variant_matches_the_script(inputs, variant):
    script = _jax_script()
    jfn = dict(all_lobes=script.all_lobes, diffuse=script.diffuse_only,
               reflect=script.reflect_only)[variant]
    want = jax.jit(jfn)({k: jnp.asarray(v) for k, v in inputs.items()})
    got = shade_ab.VARIANTS[variant](
        {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert len(got) == len(want) == 4
    names = ("wo", "f", "c_p", "l_p")
    for name, a, b in zip(names, got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        if name == "wo":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            continue
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.99, (name, close.mean())
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=name)


def test_make_inputs_draws_the_scripts_distributions():
    x = shade_ab.make_inputs(4096, seed=3)
    y = shade_ab.make_inputs(4096, seed=3)
    for k in x:
        assert torch.equal(x[k], y[k]), k
    assert not torch.equal(x["nrm"], shade_ab.make_inputs(4096, 4)["nrm"])
    for k in ("nrm", "wi"):
        np.testing.assert_allclose(x[k].norm(dim=-1).numpy(), 1.0,
                                   rtol=1e-6)
    assert ((x["wi"] * x["nrm"]).sum(-1) >= 0).all()
    for k, shape in (("roll_a", (4096, 2)), ("roll_b", (4096, 2)),
                     ("roll_c", (4096,))):
        assert x[k].shape == shape
        assert (x[k] >= 0).all() and (x[k] < 1).all()
    assert sorted(x["mat_type"].unique().tolist()) == [0, 1, 2]
    assert x["mat_type"].dtype == torch.int32
    assert (x["alpha"] == 0.2).all() and (x["ni"] == 1).all() \
        and (x["no"] == 1.5).all()


def test_cli_on_the_cpu_prints_its_figures():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.run(
        [sys.executable, "-m", "clive2_tpu_torch.scripts.shade_ab", "4096",
         "2", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines[:3]] == ["all_lobes", "diffuse",
                                                   "reflect"]
    assert all("ms for 0.00M rays (x6 depths = " in ln for ln in lines[:3])
    figures = json.loads(lines[-1])
    assert figures["n_rays"] == 4096 and figures["device"] == "cpu"
    assert set(figures["ms"]) == set(shade_ab.VARIANTS)
    assert figures["headroom_ms_per_sample"] == pytest.approx(
        6 * (figures["ms"]["all_lobes"] - min(figures["ms"]["diffuse"],
                                              figures["ms"]["reflect"])))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shade_ab.main(["4096", "1"])
