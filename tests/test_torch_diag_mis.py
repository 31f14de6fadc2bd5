"""The port's per-strategy MIS diagnostic (clive2_tpu_torch/scripts/
diag_mis.py) against the JAX package's scripts/diag_mis.py on the CPU.

* ``per_class_uni`` for k = 2..6 on the JAX run's own camera path arrays,
  within rtol 1e-6 of the script's.
* Two samples of Cornell 16x16 under key 7 (sample i: fold_in(key, i), the
  script's keys): the port's accumulated per-strategy images, and their
  means, against the script's ``one_sample`` summed the same way, at the
  golden tolerance outside near-tie pixels (tests/torch_parity.py); every
  one of the 41 strategies present.
* The identity a healthy estimator keeps: each (t, 0) strategy's
  unweighted image is the class-t unidirectional image (rtol 1e-6), and the
  report reads 1.000x uni for it.
* The CLI exits 0 with ``--device cpu`` and prints the script's lines and
  a JSON line; without a card its default raises.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu_torch import rng
from clive2_tpu_torch.scripts import diag_mis
from test_torch_estimator import _merged_paths
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP, KEY = 16, 2, 7
CLASSES = range(2, 7)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_diag_mis", os.path.join(ROOT, "scripts", "diag_mis.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs():
    """The script's and the port's SPP samples, their images summed over
    the samples, under NearTies; and the JAX run's first camera path."""
    script = _jax_script()
    js = c2.create_scene_from_preset("empty", SIZE, SIZE)
    ts = ct.create_scene_from_preset("empty", SIZE, SIZE, device="cpu")
    step = jax.jit(functools.partial(script.one_sample, width=SIZE,
                                     height=SIZE))
    key = jax.random.key(KEY)
    with NearTies() as ties:
        want_ps, want_uni = {}, {}
        for i in range(SPP):
            ps, unis = step(jax.random.fold_in(key, i), js.data)
            for ts_, images in ps.items():
                acc = want_ps.setdefault(ts_, {})
                for kind, img in images.items():
                    acc[kind] = acc.get(kind, 0) + np.asarray(img) / SPP
            for k, img in unis.items():
                want_uni[k] = want_uni.get(k, 0) + np.asarray(img) / SPP
        got_ps, got_uni = diag_mis.accumulate(ts.data, SIZE, SIZE, SPP,
                                              rng.key(KEY))
    jcam, _ = jax.jit(functools.partial(_merged_paths, "jax", size=SIZE))(
        jax.random.fold_in(key, 0), js.data)
    return dict(script=script, ties=ties, want_ps=want_ps, want_uni=want_uni,
                got_ps=got_ps, got_uni=got_uni, jcam=jcam)


@pytest.mark.parametrize("k", CLASSES)
def test_per_class_uni_matches_the_script(runs, k):
    jcam = runs["jcam"]
    want = np.asarray(runs["script"].per_class_uni(jcam, k, SIZE, SIZE))
    path = dict(vertices={n: torch.from_numpy(np.array(v))
                          for n, v in jcam["vertices"].items()},
                valid=torch.from_numpy(np.array(jcam["valid"])))
    got = diag_mis.per_class_uni(path, k, SIZE, SIZE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.shape == (SIZE, SIZE, 3)
    if k <= 4:
        assert got.sum() > 0


def test_per_strategy_means_match_the_script(runs):
    near = check_ties(runs["ties"], SIZE, SIZE)
    want, got = runs["want_ps"], runs["got_ps"]
    assert sorted(got) == sorted(want) and len(got) == 41
    for ts_, images in want.items():
        for kind, img in images.items():
            label = f"{ts_} {kind}"
            assert_match(got[ts_][kind], img, near, label)
            mask = ~near if img.ndim == 2 else ~near[..., None].repeat(3, -1)
            np.testing.assert_allclose(got[ts_][kind][mask].mean(),
                                       img[mask].mean(), rtol=2e-4,
                                       atol=1e-7, err_msg=label)
    for k in CLASSES:
        assert_match(runs["got_uni"][k], runs["want_uni"][k], near,
                     f"uni {k}")


def test_t0_strategies_are_the_unidirectional_images(runs):
    ps, unis = runs["got_ps"], runs["got_uni"]
    lines = []
    figures = diag_mis.report(ps, unis, out=lines.append)
    for k in CLASSES:
        np.testing.assert_allclose(ps[(k, 0)]["unweighted"], unis[k],
                                   rtol=1e-6, atol=0)
        assert figures[k]["strategies"][f"{k},0"]["ratio"] == \
            pytest.approx(1.0, rel=1e-6)
        assert any(ln.startswith(f"  (t={k},s=0): unweighted ")
                   and "( 1.000x uni)" in ln for ln in lines)
    assert figures[2]["uni"] > 0
    assert set(figures) == set(range(2, 13))
    assert all(figures[k]["sum_ratio"] is None for k in range(7, 13))


def test_cli_on_the_cpu_prints_the_scripts_lines():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.run(
        [sys.executable, "-m", "clive2_tpu_torch.scripts.diag_mis", "1", "8",
         "2", "3", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0] == "spp=1 size=8x8"
    # the classes "2 3" are taken and ignored, as by the script
    assert [ln.split(" (")[0] for ln in lines if ln.startswith("== class")] \
        == [f"== class k={k}" for k in range(2, 13)]
    figures = json.loads(lines[-1])
    assert sum(ln.startswith("  SUM weighted") for ln in lines) == sum(
        c["sum_ratio"] is not None for c in figures["classes"].values())
    assert figures["spp"] == 1 and figures["size"] == 8
    assert figures["n_strategies"] == 41 and sorted(
        figures["classes"], key=int) == [str(k) for k in range(2, 13)]
    assert figures["reference_mis"] is False


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_mis.main(["1", "8"])
