"""The result line and the harness's refusals: the line's keys, a run
without a card (no fallback to the CPU), a checkout without the program,
and the check for JAX by whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest, run

from .helpers import run_small, small_cell


def test_result_shape(tmp_path):
    r = run_small(small_cell(), tmp_path, seconds=1.0)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "check"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"s_per_sample", "sample_p90_s",
                                 "peak_mem_gib", "setup_s"}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert list(r["check"]) == ["off_share", "count_gap"]
    for row in r["check"].values():
        assert row["value"] <= row["limit"]
    json.dumps(r)


def test_traced_result_shape(tmp_path):
    r = run_small(small_cell(trace_samples=2), tmp_path, seconds=1.0,
                  trace=1)
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "scene_build_s" in r["metrics"]
    assert "s_per_sample" not in r["metrics"]
    assert list(r)[-1] == "check"


def _main(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


ARGS = ["--workload", "cornell.1080p", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _main(ARGS, manifest.ROOT)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run fails and prints no result."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _main(ARGS, str(tmp_path), env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("mods, bad", [
    (["clive2_tpu_torch", "clive2_tpu_torch.renderer", "jaxtyping",
      "flaxen"], []),
    (["clive2_tpu.scene", "numpy"], ["clive2_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_names_are_whole(mods, bad):
    assert run.forbidden_modules(mods) == bad


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, argparse\n"
            "from benchmark import run\n"
            "from benchmark.tests.helpers import small_cell\n"
            "r = run.run(small_cell(), argparse.Namespace("
            "workload='cornell.1080p', seed=5, seconds=0.3, trace=0), "
            "device='cpu', resources=sys.argv[1])\n"
            "assert r is not None\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = eval(out.stdout.strip().splitlines()[-1])
    assert "clive2_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "clive2_tpu"} & set(names)
