"""The package logger and the CLI's logging setup (copied from
fwav_tpu/utils/logging.py, without its device banner, which runs a jitted
JAX self-test).

The logger has a name of its own, `fwavc_torch`, so that the two
packages' lines can be told apart in one process."""

from __future__ import annotations

import logging

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
