"""The benchmark's own tests: `python -m pytest bench/tests -q` on the
CPU (the card's tests skip), `python -m pytest bench/tests -q -m card`
on a machine with the card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", 0)
