"""pytest settings of the benchmark's own tests (``python -m pytest
gpubench``): the repository's ``requires_cuda`` marker, and whether there
is a card, decided inside a fixture."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU with CUDA; skips "
        "without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")
