"""The benchmark's own tests. Run on the CPU with

    POLS_TORCH_DEVICE=cpu python -m pytest portbench/tests -q

and on the card (the ``gpu``-marked ones) with ``python -m pytest
portbench/tests -q -m gpu``. Whether a card is there is decided inside the
``cuda`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skipped with a reason where torch sees none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch sees none")
    return "cuda"
