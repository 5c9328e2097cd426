"""Shared set-up of the benchmark's own tests: the checkout root on the
path, a small CPU size for runs of the harness, a fixture that skips
where no CUDA card is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tests' size: 128^2 with the production channel count (32 of 4)
SMALL = {"nside": 128, "channelwidth": 4}


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
