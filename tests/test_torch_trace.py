"""fwav_tpu_torch/utils/trace.py against fwav_tpu/utils/trace.py: the same
phase names at the same sites of the encode, packed and stream paths (and
the port's own names for the stages the JAX package leaves unnamed), the
stream's phases equal to its `stats`, the file API's phases, the phase
tree `PARENT` against the profiler's ranges, and the collector's
semantics (per thread, nested, additive, silent without a collector, no
profiler range without a profiler)."""

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
from fwav_tpu_torch.io.wav import write_wav
from fwav_tpu_torch.models import codec
from fwav_tpu_torch.utils.trace import PARENT, collect_phases, phase, torch_profile


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


def _file_api(compact, stream=None):
    """process_file_compress on a 16-bit WAV: the 1 s speech-like file
    (damped where compact, as --compact ships it), or with `stream` (an
    objective) the stream fixture's 1 s in shards of 4,096 samples under
    a lowered STREAMING_THRESHOLD."""
    def run(tmp_path, monkeypatch):
        if stream:
            sig, sr = small_sig(seconds=1.0, seed=5)
            monkeypatch.setattr(codec, "STREAMING_THRESHOLD", len(sig) // 2)
            kw = {k: v for k, v in SMALL_KW.items() if k != "tile_size"}
            kw.update(tile=SMALL_KW["tile_size"], objective=stream)
        else:
            sig, sr = _speechlike()
            kw = {"objective": "damped"} if compact else {}
        wav = tmp_path / "in.wav"
        write_wav(str(wav), sig, sr, 2)
        res = codec.process_file_compress(str(wav), str(tmp_path), compact=compact,
                                          device="cpu", **kw)
        assert "error" not in res, res
    return run


#: The file API's paths, each with the phases it adds to its encode's.
_V2 = ["container", "container_deflate", "container_entropy", "prune", "wav_read", "write"]
FILE_PATHS = {
    "file_compact": (_file_api(True), chip_smoke.port_keys("damped") + _V2),
    "file_compact_stream_balanced": (
        _file_api(True, "balanced"), chip_smoke.port_keys("stream_balanced") + _V2),
    "file_compact_stream_damped": (
        _file_api(True, "damped"), chip_smoke.port_keys("stream_damped") + _V2),
    "file_v1": (_file_api(False), chip_smoke.port_keys("default") + ["container", "wav_read"]),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_phase_keys_are_the_jax_packages(path):
    """The port's phase table after a call holds the JAX package's keys
    after the same call, which chip_smoke.TRACE_KEYS holds, and besides
    them exactly the stages that the port names and the JAX package
    leaves unnamed (chip_smoke.PORT_KEYS)."""
    with jax_collect() as want:
        PATHS[path](jax_pkg)
    with collect_phases() as got:
        PATHS[path](port, device="cpu")
    assert sorted(want) == chip_smoke.TRACE_KEYS[path], want
    assert sorted(got) == chip_smoke.port_keys(path), (got, want)
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("path", list(FILE_PATHS))
def test_file_api_phases(path, tmp_path, monkeypatch):
    """process_file_compress names the WAV read, the prune, the container
    (v2: its entropy and deflate variants inside it) and the write; v1
    has no write of its own. The container holds its two variants."""
    run, want = FILE_PATHS[path]
    with collect_phases() as ph:
        run(tmp_path, monkeypatch)
    assert sorted(ph) == sorted(want), ph
    assert all(v > 0 for v in ph.values()), ph
    if "container_entropy" in ph:
        assert ph["container"] >= ph["container_entropy"] + ph["container_deflate"], ph


@pytest.mark.parametrize("path", list(PATHS) + ["file_compact", "file_compact_stream_damped"])
def test_parent_is_the_innermost_enclosing_phase(path, tmp_path, monkeypatch):
    """PARENT is the phase tree of every path: in a profiler trace, the
    innermost `phase.` range around each `phase.<name>` range on its
    thread is `phase.<PARENT[name]>`, and none where PARENT names none."""
    with torch_profile(tmp_path / "trace") as prof:
        if path in PATHS:
            PATHS[path](port, device="cpu")
        else:
            FILE_PATHS[path][0](tmp_path, monkeypatch)
    spans = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name()[len("phase."):])
             for e in prof.profiler.kineto_results.events() if e.name().startswith("phase.")]
    assert spans
    for i, (a, b, thread, name) in enumerate(spans):
        around = [(a2, -b2, n2) for j, (a2, b2, t2, n2) in enumerate(spans)
                  if j != i and t2 == thread and a2 <= a and b <= b2]
        inner = max(around)[2] if around else None
        assert inner == PARENT.get(name), (name, inner)


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
    assert ph["global_refit"] == pytest.approx(gp["refit_ms"] / 1e3, rel=1e-9)


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


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """A phase enters torch.profiler.record_function only while a profiler
    records: not without a collector, not with one alone; and under a
    profiler with or without a collector."""
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with phase("bare"):
        pass
    with collect_phases() as ph, phase("collected"):
        pass
    assert entered == [] and set(ph) == {"collected"}
    with torch.profiler.profile():
        with phase("profiled"):
            pass
        with collect_phases(), phase("both"):
            pass
    assert entered == ["phase.profiled", "phase.both"]


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


@pytest.mark.parametrize("path", ["encode", "file_compact_stream_damped"])
def test_torch_profile_names_each_phase(path, tmp_path, monkeypatch):
    """torch_profile writes a trace whose events include every phase as a
    `phase.<name>` range: the encode's, and the file API's and the
    stream's on the streamed compact file."""
    trace = tmp_path / "trace"
    with collect_phases() as ph, torch_profile(trace) as prof:
        if path == "encode":
            sig, sr = _speechlike()
            port.compress_audio_arrays(sig, sr, 2, device="cpu")
        else:
            FILE_PATHS[path][0](tmp_path, monkeypatch)
    if path != "encode":
        assert sorted(ph) == sorted(FILE_PATHS[path][1]), ph
    files = list(trace.glob("*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    names = {e.name for e in prof.events()}
    for key in ph:
        assert f'"phase.{key}"' in text and f"phase.{key}" in names, key
    assert isinstance(prof, torch.profiler.profile)
