"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``
from the root of a checkout. Tests that need an NVIDIA card carry the
``cuda`` marker and skip without one (decided in the ``card`` fixture)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)   # several test workers share the cores
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
