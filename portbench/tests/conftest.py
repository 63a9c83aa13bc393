"""The benchmark's own tests.  On the CPU:

    python -m pytest -p no:xdist -o addopts= portbench/tests

and on a machine with a CUDA card the same command runs the tests
marked ``card`` too; elsewhere they skip.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none (decided
    here, when the test runs, not when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
