"""pytest settings of the benchmark's own tests (``pytest perfbench/tests``).

Tests that need an NVIDIA GPU carry the ``cuda`` marker and take the
``cuda_device`` fixture, which decides at run time whether a card is
there and skips with the reason when it is not.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")
