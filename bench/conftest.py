"""Pytest settings of the benchmark's tests: the repository root and
``src`` on the path, and the ``cuda`` marker (tests that need the card
decide inside a fixture and skip elsewhere)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card of compute capability 9.0 or newer; the "
        "test skips itself elsewhere")


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU runs are tiny: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
