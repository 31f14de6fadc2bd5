"""The port's link probe (clive2_tpu_torch/scripts/link_probe.py) against
the JAX package's scripts/link_probe.py, which runs here on the CPU with its
Pallas kernel in interpret mode (about a second): the phases map onto the
script's in order, the verdict rule is the script's (held on the script's
own rows and on built rows at and across each threshold, through the
script's own ``probe``), the probe kernel's plain version is a * 2 + 1 bit
for bit, and the probe runs end to end on the CPU.  The kernel
(csrc/link_probe.cu) runs only on the card (chip_smoke.py, phase
``link_probe``).
"""

import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clive2_tpu_torch.ops.link_probe import scale_shift, scale_shift_plain
from clive2_tpu_torch.scripts import link_probe

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
import link_probe as jax_probe  # noqa: E402

# each case: {script phase: figures} set on the script's rows
CASES = [
    {},
    {"h2d_32mb": dict(mbps=49.9)},
    {"h2d_32mb": dict(mbps=50.0)},
    {"pallas_compile_first_run": dict(seconds=30.5)},
    {"pallas_compile_first_run": dict(seconds=30.0)},
    {"xla_compile_small": dict(seconds=20.5)},
    {"xla_compile_small": dict(seconds=20.0)},
    {"dispatch_x20": dict(ms_per_call=50.5)},
    {"dispatch_x20": dict(ms_per_call=50.0)},
    {"h2d_32mb": dict(mbps=10.0), "xla_compile_small": dict(seconds=40.0),
     "dispatch_x20": dict(ms_per_call=90.0)},
    {"pallas_compile_first_run": dict(seconds=99.0),
     "dispatch_x20": dict(ms_per_call=90.0)},
]


def _jax_probe(monkeypatch, case):
    """The script's ``probe()`` in interpret mode, each row it emits
    overwritten by ``case``: (its verdict, its rows)."""
    emit = jax_probe._emit

    def patched(phase, seconds, **kw):
        kw = {"seconds": seconds, **kw, **case.get(phase, {})}
        return emit(phase, **kw)

    monkeypatch.setattr(jax_probe, "_emit", patched)
    with pltpu.force_tpu_interpret_mode():
        return jax_probe.probe()


def _as_port(rows):
    """The script's rows under the port's phase names."""
    name = {v: k for k, v in link_probe.PHASES.items()}
    return [dict(r, phase=name[r["phase"]]) for r in rows]


@pytest.fixture(scope="module")
def jax_run():
    with pltpu.force_tpu_interpret_mode():
        return jax_probe.probe()


def test_phases_map_onto_the_script_in_order(jax_run):
    _, rows = jax_run
    assert list(link_probe.PHASES.values()) == [r["phase"] for r in rows]
    assert len(set(link_probe.PHASES.values())) == len(link_probe.PHASES)


def test_verdict_of_the_script_rows(jax_run):
    verdict, rows = jax_run
    assert link_probe.verdict(_as_port(rows)) == verdict


@pytest.mark.parametrize("case", CASES, ids=lambda c: "+".join(
    f"{k}={list(v.values())[0]}" for k, v in c.items()) or "as_run")
def test_verdict_rule_is_the_scripts(monkeypatch, case):
    """Rows at and across each threshold: the port's rule gives the
    script's verdict; the cases cover every verdict."""
    verdict, rows = _jax_probe(monkeypatch, case)
    assert link_probe.verdict(_as_port(rows)) == verdict


def test_the_cases_reach_every_verdict():
    got = set()
    for case in CASES:
        rows = [{"phase": k, "seconds": 0.1, **v} for k, v in case.items()]
        got.add(link_probe.verdict(_as_port(rows)))
    assert got == {"healthy", "degraded-transfer", "degraded-compile",
                   "degraded-latency"}


def test_plain_kernel_is_two_a_plus_one_bit_for_bit():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    a.ravel()[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3e38, -3e38]
    a.ravel()[8:16] = rng.uniform(-1e-38, 1e-38, 8)
    calls = scale_shift_plain.calls
    got = scale_shift(torch.from_numpy(a)).numpy()
    assert scale_shift_plain.calls == calls + 1
    with np.errstate(over="ignore"):
        want = a * np.float32(2.0) + np.float32(1.0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_probe_kernel_refuses_other_devices():
    with pytest.raises(ValueError, match="f32 CUDA tensors"):
        scale_shift(torch.zeros(4, device="meta"))


def test_probe_runs_every_phase_on_the_cpu():
    lines = []
    verdict, rows = link_probe.probe("cpu", out=lines.append)
    assert [r["phase"] for r in rows] == list(link_probe.PHASES)
    assert len(lines) == len(rows) + 1
    assert '"phase": "verdict"' in lines[-1] and verdict in lines[-1]
    assert rows[0]["platform"] == "cpu"
    assert all(r["seconds"] >= 0 for r in rows)


def test_probe_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        link_probe.probe("cuda", out=lambda line: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        link_probe.main(["--device", "cuda"])
