"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
checkout.  Tests marked `cuda` skip without a card (the check is made
inside the `card` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda:0")
