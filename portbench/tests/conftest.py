"""The card fixture of the benchmark's tests."""

import pytest


@pytest.fixture
def card():
    """The card, decided here and never at import: skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the card only)")
    return torch.device("cuda")
