"""Test settings of the benchmark's own tests (run with ``pytest h100_bench``).
Tests marked ``cuda`` need the card and skip themselves without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself where "
        "torch.cuda.is_available() is false.")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
