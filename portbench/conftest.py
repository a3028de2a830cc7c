"""pytest settings of the benchmark's own tests (`python -m pytest portbench/tests`).

Tests that need the CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch sees no card; the decision is made
inside the fixture, never while a module is imported.  On the card:
`python -m pytest portbench/tests -m card`.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card; torch sees none")
    return torch.device("cuda:0")
