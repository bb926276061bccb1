"""Tests of the benchmark harness, run on the CPU:

    python -m pytest -q perfbench/tests

They import no JAX.  A test marked `gpu` needs the card and skips inside
the test where there is none."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", torch.cuda.current_device())
