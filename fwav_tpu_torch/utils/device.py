"""The device rule of the public entry points: an explicit device, "cuda"
by default; a CPU run must be asked for, and a CUDA request without a card
raises instead of running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but no CUDA device is "
                "available; pass device='cpu' to run the plain versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
