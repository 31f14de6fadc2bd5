"""The control at a size a test run holds: the reference with TF32
operands in its ray-triangle test, put in the program's place, fails the
comparison on every seed, where the program passes it (``readings.py``
makes the same readings on the card at the cells' sizes)."""

import pytest

from benchmark import compare, readings, run

from .helpers import small_cell


@pytest.mark.parametrize("seed", [4, 2**31 + 17, 123456789])
def test_control_fails_where_the_program_passes(seed, tmp_path):
    c = small_cell(width=48, height=27)
    run._environment(str(tmp_path))
    rows = readings.readings(c, [seed], [seed], "cpu", str(tmp_path))
    prog = next(r for r in rows if r["kind"] == "program")
    ctrl = next(r for r in rows if r["kind"] == "control")
    limit = compare.LIMITS["off_share"]
    assert prog["off_share"] <= limit
    assert ctrl["off_share"] > 3 * limit


def test_tf32_rounding():
    import torch

    from benchmark.control import tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                      float("inf"), float("nan")])
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10 and y[2] == 1.0 + 2 ** -10
    assert y[3] == -3.0 - 2 ** -9
    assert y[4] == float("inf") and torch.isnan(y[5])
