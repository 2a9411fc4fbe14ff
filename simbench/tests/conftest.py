"""The benchmark's tests. Run them from the root of the repository:

    python3 -m pytest simbench/tests -q                 # the CPU tests
    python3 -m pytest simbench/tests -q -m card         # on a machine with a card

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch sees no card: the decision is made
when a test runs, never while a module is imported."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the port's CPU path is many small-tensor ops: one thread per process
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch sees none here")
    return torch.device("cuda")
