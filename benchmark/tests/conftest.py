"""The benchmark's own tests (``python3 -m pytest -q benchmark/tests``).
They run on the CPU at small sizes; those marked ``cuda`` need a card and
skip without one (decided in a fixture, never at import)."""

import os

import pytest

# the harness's CPU runs read no knob of the program
for _k in [k for k in os.environ if k.startswith("CLIVE2_")]:
    del os.environ[_k]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
