"""Settings of graphbench's tests.  They run on the CPU at small scales;
the tests marked `gpu` need a CUDA card and skip without one (decided in
the `card` fixture, never at import):

    python -m pytest graphbench/tests -q              # here, on the CPU
    python -m pytest graphbench/tests -q -m gpu       # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def bench():
    from graphbench import manifest
    return manifest.load_benchmark()
