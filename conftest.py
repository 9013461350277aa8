"""Repository-wide pytest set-up, loaded before tests/conftest.py.

The JAX package builds its native library fwav_tpu/native/libfwavio.so at
first use, with g++ writing straight to the final path. Test workers that
start together on a fresh tree race on that build, and a worker that loads
a half-written file skips tests/test_native_rans.py and
tests/test_native_refit.py for the rest of its life (their `skipif` asks
fwav_tpu.io.native.available() at collection). So the process that starts
the workers (the xdist controller, or the only process of a run without
workers) builds the library here, atomically, before any worker starts
(tests/native_libs.py build_if_stale), when it is missing or older than its
source; otherwise this does nothing. A build that fails is reported as a
warning and leaves the JAX package to build at first use, as before (its
byte-parity modules fail loudly then through
tests/native_libs.ensure_native_libraries).

It imports neither jax nor fwav_tpu: tests/conftest.py pins JAX to the CPU
and must run before the first jax import.
"""

import shutil
import subprocess
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from native_libs import build_if_stale  # noqa: E402


def pytest_configure(config):
    if hasattr(config, "workerinput") or shutil.which("g++") is None:
        return  # a worker, or no compiler: the JAX package falls back as before
    try:
        build_if_stale()
    except (subprocess.SubprocessError, OSError) as e:
        warnings.warn(f"building fwav_tpu/native/libfwavio.so failed: {e}", stacklevel=1)
