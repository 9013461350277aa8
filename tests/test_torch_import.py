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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.decompress_segment(rec, bank, n, rs, 0, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compress_audio_packed([sig], sr, sw)
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
                 "compress_audio_streaming", "save_compressed_streaming",
                 "compress_audio_packed", "save_compressed_multi", "load_compressed_multi",
                 "decompress_segment", "read_wav"):
        assert callable(getattr(port, name)), name
        assert name in port.__all__, name
    assert port.TOP_K == 32 and port.PACK_B_MAX == 16
    assert port.decompress_audio([], None, 0, 4, mesh=None, device="cpu").size == 0
    from fwav_tpu_torch.parallel import make_mesh

    assert port.decompress_audio([], None, 0, 4, mesh=make_mesh(2, device="cpu")).size == 0
    assert port.MATCH_DTYPE.itemsize == 17 and np.dtype(port.MATCH_DTYPE).names[0] == "idx"
    assert port.DAMPED_DECODE_DAMPING == 0.25


def test_parallel_package_has_the_jax_packages_names():
    """fwav_tpu_torch.parallel exports the JAX package's parallel names but
    its NamedSharding helpers (no caller outside fwav_tpu/parallel; ROADMAP
    "Not ported"), plus Mesh and fetch_global; loading it alone loads
    neither jax nor fwav_tpu."""
    import fwav_tpu.parallel as jp

    import fwav_tpu_torch.parallel as tp

    helpers = {"ranges_sharding", "bank_sharding", "replicated"}
    assert set(tp.__all__) == (set(jp.__all__) - helpers) | {"Mesh", "fetch_global"}
    assert (tp.DP_AXIS, tp.TP_AXIS) == (jp.DP_AXIS, jp.TP_AXIS)
    code = ("import sys, fwav_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fwav_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_exports_cover_the_jax_packages_ported_names():
    """Every top-level name of the JAX package (its __all__ in full) is a
    top-level name here, resolves, and means the same."""
    import inspect

    import fwav_tpu

    missing = set(fwav_tpu.__all__) - set(port.__all__)
    assert not missing, sorted(missing)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for name in ("TOP_K", "EMBED_K", "FWAV_VERSION"):
        assert getattr(port, name) == getattr(fwav_tpu, name), name
    assert port.MATCH_DTYPE == fwav_tpu.MATCH_DTYPE
    for name in fwav_tpu.__all__:
        if inspect.isfunction(getattr(fwav_tpu, name)):
            assert callable(getattr(port, name)), name
    assert port.TOP_K == fwav_tpu.TOP_K
    assert port.PACK_B_MAX == fwav_tpu.models.encode.PACK_B_MAX
    jax_sig = inspect.signature(fwav_tpu.decompress_audio).parameters
    port_sig = inspect.signature(port.decompress_audio).parameters
    assert set(jax_sig) <= set(port_sig) and port_sig["mesh"].default is None
    assert set(inspect.signature(fwav_tpu.compress_audio_packed).parameters) <= set(
        inspect.signature(port.compress_audio_packed).parameters)
    assert list(inspect.signature(fwav_tpu.decompress_segment).parameters) == list(
        inspect.signature(port.decompress_segment).parameters)


def test_read_wav_keeps_the_channels(tmp_path):
    """read_wav, now a top-level name: the (n, channels) array that the
    multichannel container's callers start from."""
    import wave

    rng = np.random.default_rng(0)
    pcm = rng.integers(-2000, 2000, (800, 2)).astype("<i2")
    with wave.open(str(tmp_path / "st.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.tobytes())
    import fwav_tpu

    got, want = port.read_wav(tmp_path / "st.wav"), fwav_tpu.read_wav(tmp_path / "st.wav")
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (800, 2)


#: The JAX package's sub-package names that the port spells otherwise.
RENAMED = {"voiced_mask_jax": "voiced_mask", "build_bank_jax": "build_bank",
           "jax_profile": "torch_profile"}


@pytest.mark.parametrize("sub", ["ops", "utils", "io"])
def test_subpackages_export_the_jax_names(sub):
    """fwav_tpu_torch.ops, .utils and .io export their JAX sub-packages'
    __all__ under the written renames (utils adds resolve_device), and
    every name resolves."""
    import importlib

    jax_all = importlib.import_module(f"fwav_tpu.{sub}").__all__
    mod = importlib.import_module(f"fwav_tpu_torch.{sub}")
    want = {RENAMED.get(n, n) for n in jax_all}
    extra = {"resolve_device"} if sub == "utils" else set()
    if sub == "io":  # the port's io also exports the v2 and streaming names
        extra = set(mod.__all__) - want
        assert extra <= set(port.__all__), extra
    assert set(mod.__all__) == want | extra
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name
    assert not set(RENAMED) & set(mod.__all__)


def test_ops_package_loads_no_kernels():
    """Importing fwav_tpu_torch.ops, or an op that needs no scan, does not
    load ops/kernels.py; an op that does loads it at first use."""
    code = ("import sys, fwav_tpu_torch.ops as ops\n"
            "from fwav_tpu_torch.ops import voiced_detection, build_bank, box_sums\n"
            "assert 'fwav_tpu_torch.ops.kernels' not in sys.modules\n"
            "ops.coarse_refine_search\n"
            "assert 'fwav_tpu_torch.ops.kernels' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.fixture
def fresh_banners(monkeypatch):
    from fwav_tpu_torch.utils import logging as plog

    monkeypatch.setattr(plog, "_banners", {})
    return plog


def test_device_banner_logs_once_per_device(fresh_banners, speechlike, caplog):
    """The first encode on a device logs its banner; later ones do not;
    the banner launches none of the port's kernels."""
    from fwav_tpu_torch.ops import kernels

    sig, sr, sw = speechlike
    before = dict(kernels.LAUNCHES)
    with caplog.at_level("INFO", logger="fwavc_torch"):
        msg = port.utils.device_banner("cpu")
        assert kernels.LAUNCHES == before
        port.compress_audio_arrays(sig, sr, sw, device="cpu")
        port.compress_audio_packed([sig], sr, sw, device="cpu")
    lines = [r.getMessage() for r in caplog.records if "[FWAVC-TORCH]" in r.getMessage()]
    assert lines == [msg] and "backend=cpu" in msg and msg.endswith("self-test=ok")
    assert port.utils.device_banner(torch.device("cpu")) == msg


def test_device_banner_raises_when_its_self_test_fails(fresh_banners, speechlike):
    """No fallback: a failed self-test raises, and the encode with it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fresh_banners, "_self_test", lambda dev: False)
        with pytest.raises(RuntimeError, match="self-test=FAILED"):
            fresh_banners.device_banner("cpu")
        sig, sr, sw = speechlike
        with pytest.raises(RuntimeError, match="self-test=FAILED"):
            port.compress_audio_arrays(sig, sr, sw, device="cpu")
    assert fresh_banners._banners == {}
    assert fresh_banners.device_banner("cpu").endswith("self-test=ok")
