"""fwav_tpu_torch stands alone: no module of it loads jax or fwav_tpu, and
its entry points never fall back to the CPU when a CUDA device was asked
for and there is none."""

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


def test_cuda_request_without_a_card_raises(speechlike):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be honoured")
    sig, sr, sw = speechlike
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compress_audio_arrays(sig, sr, sw)  # device="cuda" by default
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
                 "load_compressed_compact", "parse_decode_hint"):
        assert callable(getattr(port, name)), name
    assert port.MATCH_DTYPE.itemsize == 17 and np.dtype(port.MATCH_DTYPE).names[0] == "idx"
    assert port.DAMPED_DECODE_DAMPING == 0.25
