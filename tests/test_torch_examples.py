"""The examples/torch_*.py scripts (the port's counterparts of the
README's examples) run end to end on the CPU with tests/test_examples.py's
small arguments; without --device cpu they need a card."""

import runpy
import sys

import pytest
import torch

EXAMPLES = [
    ("examples/torch_round_trip.py", []),
    ("examples/torch_multichannel.py", []),
    ("examples/torch_long_damped.py", ["--seconds", "2"]),
]


@pytest.mark.parametrize("path,args", EXAMPLES,
                         ids=[p.split("/")[-1] for p, _ in EXAMPLES])
def test_torch_example_runs(path, args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [path, *args, "--device", "cpu"])
    runpy.run_path(path, run_name="__main__")
    out = capsys.readouterr().out
    assert "SNR" in out


@pytest.mark.parametrize("path,args", EXAMPLES,
                         ids=[p.split("/")[-1] for p, _ in EXAMPLES])
def test_torch_example_without_a_card_fails(path, args, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would be used")
    monkeypatch.setattr(sys, "argv", [path, *args])
    with pytest.raises((SystemExit, RuntimeError), match="CUDA|cuda"):
        runpy.run_path(path, run_name="__main__")
