"""Shared fixtures of the benchmark's tests: a tiny traffic mix for runs
on the CPU, and the card's fixture for the tests marked `cuda`."""

import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent


@pytest.fixture
def tiny_mix():
    """The 10 s mix cut to three files of 1.5-2.5 s, two of them checked."""
    mix = json.loads((HERE / "traffic" / "speech10s.json").read_text())
    mix.update(pool_files=3, seconds=[1.5, 2.5], check_files=2)
    return mix


@pytest.fixture
def card():
    """Skips where no CUDA card is present; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
