"""fwav_tpu_torch stands alone: no module of it loads jax or fwav_tpu, and
its entry points never fall back to the CPU when a CUDA device was asked
for and there is none."""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fwav_tpu_torch as port

REPO = Path(__file__).resolve().parent.parent


def test_no_module_imports_jax_or_fwav_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fwav_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(fwav_tpu_torch.__path__, 'fwav_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fwav_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


#: A path under the JAX package: `fwav_tpu` as a path component.
_JAX_PATH = re.compile(r"(?<![\w.])fwav_tpu(?=[/\\\"']|$)")


def _code_strings(path: Path):
    """The string literals of a Python file outside its docstrings, or the
    text of a C++/CUDA file outside its comments."""
    text = path.read_text()
    if path.suffix != ".py":
        return [re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)]
    tree = ast.parse(text)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_names_no_path_of_the_jax_package():
    """No file of fwav_tpu_torch reads or builds a file of fwav_tpu: the
    port keeps its own copies (comments and docstrings may cite them)."""
    files = [p for p in (REPO / "fwav_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cpp", ".cu", ".cuh") and "_build" not in p.parts]
    assert len(files) > 20 and any(p.suffix == ".cu" for p in files)
    bad = {str(p.relative_to(REPO)): s for p in files for s in _code_strings(p)
           if _JAX_PATH.search(s)}
    assert not bad, bad
    assert _JAX_PATH.search("fwav_tpu/native/fwavio.cpp")  # the pattern bites
    assert _JAX_PATH.search("fwav_tpu") and not _JAX_PATH.search("fwav_tpu_torch/io")
    from fwav_tpu_torch.io import native

    assert native._SRC == REPO / "fwav_tpu_torch" / "native" / "fwavio.cpp"


def test_native_source_is_a_copy_of_the_jax_packages():
    """fwav_tpu_torch/native/fwavio.cpp is the JAX package's byte for byte,
    so that a change to either is seen."""
    ours = (REPO / "fwav_tpu_torch" / "native" / "fwavio.cpp").read_bytes()
    assert ours == (REPO / "fwav_tpu" / "native" / "fwavio.cpp").read_bytes()


def test_cuda_request_without_a_card_raises(speechlike):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be honoured")
    sig, sr, sw = speechlike
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compress_audio_arrays(sig, sr, sw)  # device="cuda" by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compress_audio_streaming(sig, sr, sw)
    rec, bank, n, rs, *_ = port.compress_audio_arrays(sig, sr, sw, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.decompress_audio(rec, bank, n, rs)
    with pytest.raises(ValueError, match="unsupported device"):
        port.compress_audio_arrays(sig, sr, sw, device="meta")


def test_kernel_wrappers_refuse_other_devices():
    from fwav_tpu_torch.ops import kernels

    t = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.search_scan(t, t.T, t[0], t[0])
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.topc_scan(t, t.T, t[0], t[0], 4)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and in a directory without the rest of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    runs = [REPO]
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone)
    runs.append(lone)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == "", (cwd, out)


def test_public_api_exports():
    for name in ("compress_audio_arrays", "compress_audio", "decompress_audio",
                 "save_compressed", "load_compressed", "read_wav_mono",
                 "write_wav", "compute_snr", "save_compressed_compact",
                 "load_compressed_compact", "parse_decode_hint",
                 "compress_audio_streaming", "save_compressed_streaming"):
        assert callable(getattr(port, name)), name
    assert port.MATCH_DTYPE.itemsize == 17 and np.dtype(port.MATCH_DTYPE).names[0] == "idx"
    assert port.DAMPED_DECODE_DAMPING == 0.25
