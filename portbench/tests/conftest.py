"""CPU tests of the port's benchmark. Tests that need the card carry the
``cuda`` marker and skip without one (decided inside the test)."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda", 0)
