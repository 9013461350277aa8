"""fwav_tpu_torch/utils/trace.py against fwav_tpu/utils/trace.py: the same
phase names at the same sites of the encode, packed and stream paths, the
stream's phases equal to its `stats`, and the collector's semantics (per
thread, nested, additive, silent without a collector)."""

import threading

import numpy as np
import pytest
import torch
from test_global_candidates import KW as SMALL_KW
from test_global_candidates import _sig as small_sig

import chip_smoke
import fwav_tpu as jax_pkg
import fwav_tpu_torch as port
from fwav_tpu.utils.trace import collect_phases as jax_collect
from fwav_tpu_torch.utils.trace import collect_phases, phase, torch_profile


def _speechlike(sr=16000, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.2 * np.sin(2 * np.pi * 800 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    sig[int(0.3 * sr) : int(0.4 * sr)] = 0.0
    return (sig * 16000).astype(np.float32), sr


def _quiet(sr=16000):
    """Under the energy gate everywhere: every range is a sentinel."""
    return (0.001 * np.random.default_rng(1).standard_normal(sr)).astype(np.float32), sr


def _single(kw, make=_speechlike):
    def run(encode, **dev):
        sig, sr = make()
        encode.compress_audio_arrays(sig, sr, 2, **kw, **dev)
    return run


def _packed(encode, **dev):
    sig, sr = _speechlike()
    encode.compress_audio_packed([sig, sig[:12000]], sr, 2, **dev)


def _stream(objective):
    def run(encode, **dev):
        sig, sr = small_sig(seconds=1.0, seed=5)
        encode.compress_audio_streaming(sig, sr, 2, **{**SMALL_KW, "objective": objective},
                                        **dev)
    return run


#: The paths of chip_smoke.TRACE_KEYS, each run through both packages.
PATHS = {
    "default": _single({}),
    "damped": _single({"objective": "damped"}),
    "fast_mode_false": _single({"fast_mode": False}),
    "all_sentinel": _single({}, make=_quiet),
    "packed": _packed,
    "stream_balanced": _stream("balanced"),
    "stream_damped": _stream("damped"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_phase_keys_are_the_jax_packages(path):
    """The port's phase table after a call has the JAX package's keys
    after the same call, and chip_smoke.TRACE_KEYS holds them."""
    with jax_collect() as want:
        PATHS[path](jax_pkg)
    with collect_phases() as got:
        PATHS[path](port, device="cpu")
    assert sorted(got) == sorted(want) == chip_smoke.TRACE_KEYS[path], (got, want)
    assert all(v > 0 for v in got.values()), got


def test_streaming_phases_are_attributable():
    """tests/test_global_candidates.py::test_streaming_phase_timings_cover_the_pass
    on the port: slow encodes are attributable."""
    sig, sr = small_sig(seconds=1.0, seed=5)
    with collect_phases() as phases:
        port.compress_audio_streaming(sig, sr, 2, device="cpu", **SMALL_KW)
    for key in ("vad", "dispatch", "fetch_wait", "host_refit", "global_pass"):
        assert phases.get(key, 0) > 0, (key, phases)


@pytest.mark.parametrize("resume", [False, True], ids=["plain", "resume_dir"])
def test_stream_phases_equal_its_stats(resume, tmp_path):
    """Phases (s) and stats (ms) read one clock: dispatch = H2D + enqueue,
    fetch_wait = wait, host_refit = refit (without the checkpoint save),
    and the pass's global_h2d / global_dispatch / global_fetch, with
    global_pass their sum."""
    sig, sr = small_sig(seconds=1.0, seed=5)
    stats = {}
    kw = {"resume_dir": str(tmp_path)} if resume else {}
    with collect_phases() as ph:
        port.compress_audio_streaming(sig, sr, 2, device="cpu", stats=stats, **SMALL_KW, **kw)
    shards = stats["shards"]
    assert len(shards) == 2

    def total(key):
        return sum(s[key] for s in shards) / 1e3

    assert ph["vad"] == pytest.approx(stats["vad_ms"] / 1e3, rel=1e-9)
    assert ph["dispatch"] == pytest.approx(total("h2d_ms") + total("enqueue_ms"), rel=1e-9)
    assert ph["fetch_wait"] == pytest.approx(total("wait_ms"), rel=1e-9)
    if resume:
        assert 0 < ph["host_refit"] < total("refit_ms")
    else:
        assert ph["host_refit"] == pytest.approx(total("refit_ms"), rel=1e-9)
    gp = stats["global_pass"]
    assert ph["global_h2d"] == pytest.approx(gp["h2d_ms"] / 1e3, rel=1e-9)
    assert ph["global_dispatch"] == pytest.approx(gp["enqueue_ms"] / 1e3, rel=1e-9)
    assert ph["global_fetch"] == pytest.approx(gp["wait_ms"] / 1e3, rel=1e-9)
    assert ph["global_pass"] == pytest.approx(
        ph["global_h2d"] + ph["global_dispatch"] + ph["global_fetch"], rel=1e-9)


@pytest.mark.parametrize("packed", [False, True], ids=["single", "packed"])
def test_encode_phases_nest(packed):
    """device contains d2h, which contains host_bank; refit follows."""
    sig, sr = _speechlike()
    with collect_phases() as ph:
        if packed:
            port.compress_audio_packed([sig, sig[:12000]], sr, 2, device="cpu")
        else:
            port.compress_audio_arrays(sig, sr, 2, device="cpu")
    assert ph["device"] >= ph["d2h"] >= ph["host_bank"] > 0 and ph["refit"] > 0, ph


def test_phases_add_up_and_nothing_without_a_collector():
    with phase("orphan"):  # no collector: recorded nowhere, no error
        pass
    with collect_phases() as ph:
        for _ in range(3):
            with phase("x"):
                pass
        first = ph["x"]
        with phase("x"):
            pass
    assert set(ph) == {"x"} and ph["x"] > first > 0
    with collect_phases() as fresh:
        pass
    assert fresh == {}


def test_nested_collectors_restore_the_outer_sink():
    with collect_phases() as outer:
        with phase("a"):
            pass
        with collect_phases() as inner:
            with phase("b"):
                pass
        with phase("c"):
            pass
    assert set(outer) == {"a", "c"} and set(inner) == {"b"}


def test_phases_are_per_thread():
    """A phase in another thread lands in that thread's sink, not here."""
    seen = {}

    def other():
        with phase("elsewhere"):
            pass
        with collect_phases() as mine:
            with phase("theirs"):
                pass
        seen.update(mine)

    with collect_phases() as here:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with phase("here"):
            pass
    assert set(here) == {"here"} and set(seen) == {"theirs"}


def test_torch_profile_names_each_phase(tmp_path):
    """torch_profile writes a trace whose events include every phase as a
    `phase.<name>` range."""
    sig, sr = _speechlike()
    with collect_phases() as ph, torch_profile(tmp_path) as prof:
        port.compress_audio_arrays(sig, sr, 2, device="cpu")
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    names = {e.name for e in prof.events()}
    for key in ph:
        assert f'"phase.{key}"' in text and f"phase.{key}" in names, key
    assert isinstance(prof, torch.profiler.profile)
