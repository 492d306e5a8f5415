"""The benchmark's own tests: ``python -m pytest slambench/tests -q`` from the
repository root.  Tests marked ``cuda`` need a card and skip without one;
they run on the card with ``python -m pytest slambench/tests -m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
