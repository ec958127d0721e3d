"""The benchmark's own tests (``python -m pytest portbench/tests``), on the
CPU at small sizes.  A test that needs the card takes the ``card`` fixture,
which decides at run time, and carries the ``card`` marker."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's device runs happen on the chip")
    return torch.device("cuda", 0)


def tiny_cell(name: str, universities: int) -> dict:
    """The cell ``name`` with its configuration cut to ``universities``."""
    from portbench import spec

    c = spec.cell(name)
    c["config"]["universities"] = universities
    return c
