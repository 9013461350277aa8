"""Build and bind the CUDA kernels in fwav_tpu_torch/csrc.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, at first use, into the package's `_build/` directory
(listed in .gitignore); the library is rebuilt when a source is newer. It
is loaded with ctypes. Nothing here runs at import: `nvcc` is looked up
and run only inside `build`, so the package imports where there is none.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libfwav_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels in fwav_tpu_torch/csrc cannot be built"
    )


def build() -> tuple[Path, str]:
    """Compile the kernels if the library is missing or older than a
    source. Returns (library path, compiler log; empty when up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    deps = sources + sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in deps)
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    try:
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
                )
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, "".join(logs)


def load():
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fwav_error_string.restype = ctypes.c_char_p
    lib.fwav_error_string.argtypes = [i]
    lib.fwav_search_scan.restype = i
    lib.fwav_search_scan.argtypes = [
        p, p, p, p, p, f, i, i, i, i, i, p, p, p, p, p,
    ]
    lib.fwav_topc_scan.restype = i
    lib.fwav_topc_scan.argtypes = [p, p, p, p, p, f, i, i, i, i, p, p]
    lib.fwav_refine_window.restype = i
    lib.fwav_refine_window.argtypes = [
        p, i, p, p, i, i, i, i, i, i, f, p, p, p,
    ]
    return lib


def check(lib, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if code != 0:
        msg = lib.fwav_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
