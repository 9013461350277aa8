"""The native build of the repository's root conftest.py
(tests/native_libs.py build_if_stale), which the process that starts the
test workers runs before they start: on a temporary copy of the JAX
package's source, it builds once, atomically, leaves a library newer than
its source that loads, and does not build again while it is up to date.
The root conftest.py imports neither jax nor fwav_tpu (tests/conftest.py
must pin JAX to the CPU before the first jax import)."""

import ctypes
import os
import runpy
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from native_libs import NATIVE_SRC, build_if_stale

ROOT = Path(__file__).resolve().parent.parent


def test_build_if_stale_builds_once_and_loads(tmp_path):
    src, lib = tmp_path / "fwavio.cpp", tmp_path / "libfwavio.so"
    shutil.copy(NATIVE_SRC, src)
    past = src.stat().st_mtime_ns - 10**10
    os.utime(src, ns=(past, past))
    assert build_if_stale(src, lib)
    built = lib.stat().st_mtime_ns
    assert built > src.stat().st_mtime_ns
    assert not build_if_stale(src, lib)
    assert lib.stat().st_mtime_ns == built
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fwavio.cpp", "libfwavio.so"]
    assert ctypes.CDLL(str(lib)).fwav_write
    newer = built + 10**9
    os.utime(src, ns=(newer, newer))
    assert build_if_stale(src, lib)


def test_root_conftest_imports_neither_jax_nor_the_package():
    code = ("import runpy, sys; runpy.run_path('conftest.py'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fwav_tpu'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=60)


def test_root_conftest_warns_when_the_build_fails():
    """A failing g++ costs a warning, not the test session."""
    configure = runpy.run_path(str(ROOT / "conftest.py"))["pytest_configure"]

    def fail():
        raise subprocess.CalledProcessError(1, ["g++"])

    configure.__globals__.update(build_if_stale=fail,
                                 shutil=types.SimpleNamespace(which=lambda name: name))
    with pytest.warns(UserWarning, match="libfwavio.so failed"):
        configure(types.SimpleNamespace())
