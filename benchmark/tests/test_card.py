"""On the card (skipped without one): a small Cornell cell through the
harness, with the kernels, the CUDA events and the check."""

import pytest

from benchmark import run

from .helpers import args, small_cell


@pytest.mark.cuda
def test_small_cornell_on_the_card(card, tmp_path):
    c = small_cell(width=96, height=54)
    r = run.run(c, args("cornell.1080p", seconds=2.0), device=str(card),
                resources=str(tmp_path))
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["memory_peak_bytes"] > 0
    assert r["metrics"]["s_per_sample"]["value"] > 0
