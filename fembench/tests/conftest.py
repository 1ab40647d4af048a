"""Tests of the benchmark's harness, on the CPU at small sizes:

    python -m pytest fembench/tests -q

The card's tests take the `cuda` fixture, which skips where there is no
CUDA device; nothing decides that at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
