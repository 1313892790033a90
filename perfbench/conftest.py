"""pytest settings of the benchmark's own tests (``perfbench/tests``).

``card`` marks a test that needs a CUDA device; its ``card`` fixture skips
it without one, decided when the test runs, never at import, so every
worker collects the same tests. On the card:
``PYTHONPATH=src python -m pytest -q -m card perfbench/tests``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
