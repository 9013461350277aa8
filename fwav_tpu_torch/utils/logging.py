"""The package logger, the CLI's logging setup and the device banner
(copied from fwav_tpu/utils/logging.py; the banner's self-test is a torch
reduction on the device the encode runs on).

The logger has a name of its own, `fwavc_torch`, so that the two
packages' lines can be told apart in one process."""

from __future__ import annotations

import logging
import threading

import torch

#: A library never calls logging.basicConfig: only its own logger is set,
#: and it propagates to the application's handlers. The CLI calls
#: configure_cli_logging() for the standalone run.
logger = logging.getLogger("fwavc_torch")
logger.setLevel(logging.INFO)


def configure_cli_logging() -> None:
    """Root-logger setup for the standalone CLI (not for library use)."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s: %(message)s"
    )


#: The banner of each device that passed its self-test, by device name.
_banners: dict = {}
_banner_lock = threading.Lock()


def _self_test(dev: torch.device) -> bool:
    """A small reduction on `dev`, read back: 0 + 1 == 1."""
    try:
        return int(torch.arange(2, device=dev).sum().item()) == 1
    except Exception:  # noqa: BLE001 - any failure of the device is a failed test
        return False


def device_banner(device="cuda") -> str:
    """One line on the device an encode runs on (backend, name, device
    count, self-test), logged the first time that device is used and
    returned. The JAX package's banner warns and carries on when its
    self-test fails; this one raises RuntimeError, as the port never falls
    back to another device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _banner_lock:
        if key in _banners:
            return _banners[key]
        if dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
            count = torch.cuda.device_count()
        else:
            name, count = dev.type, 1
        msg = f"[FWAVC-TORCH] backend={dev.type} device={name} devices={count}"
        if not _self_test(dev):
            raise RuntimeError(f"{msg} self-test=FAILED: the device failed its smoke test")
        msg += " self-test=ok"
        logger.info(msg)
        _banners[key] = msg
        return msg
