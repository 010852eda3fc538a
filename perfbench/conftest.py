"""pytest settings of the benchmark's own tests (`python3 -m pytest
perfbench/tests`): the `card` marker, for tests that need a CUDA card and
skip without one (decided inside the test, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
