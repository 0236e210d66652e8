"""Tests of the benchmark's harness. They run on the CPU at small sizes;
those that need the card are marked `cuda` and skip without one (the card
is looked for inside the `card` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes at which the program and the reference agree on the CPU (below
# ~128^3 the IK's wrist is flat enough that a 24-iteration solve stops short)
SMALL = {"bench256": {"grid": [128, 128, 128], "cube_size": 128},
         "clinical512": {"grid": [256, 256, 96], "cube_size": 128}}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="session")
def root():
    return ROOT
