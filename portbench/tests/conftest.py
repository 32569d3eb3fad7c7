"""The benchmark's own tests. Run them from the repository's root:

    python3 -m pytest portbench/tests -q              # on the CPU; card tests skip
    python3 -m pytest portbench/tests -q -m card      # on the machine with the card

Tests marked ``card`` decide inside the ``card`` fixture whether there is
a CUDA device, and skip without one."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
for p in (str(REPO), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's precision on the card")
    return "cuda:0"


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny CPU cells added as files."""
    import helpers

    root = helpers.copy_bench(tmp_path)
    names = [helpers.add_cell(root, c, t) for c, t in (
        ("utnet_tiny", "photos_tiny"), ("utnet_tiny", "train_tiny"),
        ("unet_tiny", "photos_tiny"), ("unet_tiny", "train_tiny"))]
    return root, names
