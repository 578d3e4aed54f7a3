"""Tests of the benchmark's own files.  ``card`` tests need a CUDA card;
whether there is one is decided in the ``cuda`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return "cuda"
