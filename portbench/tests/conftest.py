"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of a checkout (the card's tests skip without one).  They import the
benchmark as the package ``portbench`` and the port from ``src/``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips, with its reason, "
                   "where none is present")


@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
