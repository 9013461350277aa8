"""Both packages' native .fwav libraries, loaded before a test compares
record bytes of fwav_tpu_torch with the JAX package's.

The host refit that makes the stored s, o, err and orientation has a
native version (fwavio.cpp's fwav_collect) and a numpy fallback, and the
two do not give the same bytes: on the topk encode of bench.make_signal(1.0)
their records differ in 7.44% of bytes with the same idx
(scripts/compare_native_fallback.py). A parity test is only sound when both
packages took the native path.

The JAX package builds fwav_tpu/native/libfwavio.so at first use with g++
writing straight to its final path. Test workers that start together can
load a half-written file, and the one that does keeps the numpy fallback for
the rest of its life. `ensure_native_libraries` (called at import by every
test file that compares record bytes with the JAX package) builds that
library itself, to a temporary file renamed into place, whenever it is
missing or older than its source, then loads both packages' libraries and
raises if either is missing: never one side on the fallback alone.

The module imports neither package at its top: the repository's root
conftest.py builds the JAX package's library with `build_if_stale` in the
xdist controller, before any worker starts and before tests/conftest.py
pins JAX to the CPU, so nothing here may import jax or fwav_tpu until
`ensure_native_libraries` runs.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

#: The JAX package's native source and the library it builds beside it
#: (fwav_tpu/io/native.py _SRC and _LIB).
NATIVE_SRC = Path(__file__).resolve().parent.parent / "fwav_tpu" / "native" / "fwavio.cpp"
NATIVE_LIB = NATIVE_SRC.with_name("libfwavio.so")


def _build_atomically(src: Path, lib: Path) -> None:
    """g++ as the JAX package invokes it (with -march=native, then without
    it where that fails), into a temporary file renamed over `lib`."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(base[:1] + ["-march=native"] + base[1:], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        subprocess.run(base, check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib)


def _stale(src: Path, lib: Path) -> bool:
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_if_stale(src: Path = NATIVE_SRC, lib: Path = NATIVE_LIB) -> bool:
    """Build `lib` from `src` atomically when it is missing or older than
    its source; returns whether it built."""
    if not _stale(src, lib):
        return False
    _build_atomically(src, lib)
    return True


def ensure_native_libraries() -> None:
    from fwav_tpu.io import native as jax_native
    from fwav_tpu_torch.io import native as port_native

    src = Path(jax_native._SRC).resolve()
    lib = Path(jax_native._LIB).resolve()
    if (src, lib) != (NATIVE_SRC, NATIVE_LIB):
        raise RuntimeError(f"the JAX package's native paths moved: {src}, {lib}")
    if shutil.which("g++") is None:
        raise RuntimeError("g++ is missing: the native libraries cannot be built, and "
                           "a parity test of record bytes needs both")
    for attempt in range(2):
        if attempt or _stale(src, lib):
            _build_atomically(src, lib)
            with jax_native._lock:
                jax_native._lib, jax_native._tried = None, False
        if jax_native._load() is not None:
            break
    else:
        raise RuntimeError(f"the JAX package's native library {lib} does not load")
    if port_native._load() is None:
        raise RuntimeError("fwav_tpu_torch's native library does not load")
