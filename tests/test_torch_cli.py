"""The port's file API and CLI (`python -m fwav_tpu_torch`, run in-process
with --device cpu) against the JAX package's CLI (fwav_tpu.cli.main) in
the same process, on WAVs written from seeded numpy signals.

The JAX CLI runs its kernel path (EncoderConfig.use_pallas=True, Pallas in
interpret mode on the CPU), which its CLI takes on a TPU and which the
port mirrors; the `jax_kernel_path` fixture sets that default for the
duration of a test, nothing in the JAX package changes.

Bar, per fixture and flag set: the same sentinel set; the stored tiles of
at most 2 ranges per 1,024 differ (idx compared by the bank rows they
point at, since each file prunes its bank to the rows it uses); the
round-trip SNR within 0.01 dB; the silent gap of the verify tone decodes
to exact zeros; the .fwav bytes are equal wherever the records and banks
are. `info` prints the same JSON with the same exit code; `snr` the same
report. Batch mode keeps the JAX CLI's metrics keys, its skip-resume and
its per-file isolation; --workers 4 writes the bytes --workers 1 writes;
--batch --packed writes each file as the single-file encode does.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

import bench
from fwav_tpu import cli as jax_cli
from fwav_tpu_torch import cli as port_cli
from fwav_tpu_torch.io.container import load_compressed_arrays
from fwav_tpu_torch.io import multich
from fwav_tpu_torch.io.multich import load_compressed_multi
from fwav_tpu_torch.io.wav import read_wav, read_wav_mono, write_wav
from fwav_tpu_torch.ops import near_tie
from fwav_tpu_torch.utils.metrics import compute_snr
from native_libs import ensure_native_libraries

ensure_native_libraries()

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX package's EncoderConfig with use_pallas=True by default, in
    the modules whose entry points build one from keywords."""
    import fwav_tpu.models.encode as jax_encode
    import fwav_tpu.models.stream as jax_stream
    from fwav_tpu.config import EncoderConfig

    @dataclasses.dataclass(frozen=True)
    class KernelPath(EncoderConfig):
        use_pallas: Optional[bool] = True

    monkeypatch.setattr(jax_encode, "EncoderConfig", KernelPath)
    monkeypatch.setattr(jax_stream, "EncoderConfig", KernelPath)


def _verify_tone():
    """The tone of the repository's verify recipe: 1.2 s at
    16 kHz, 330 + 990 Hz, with a silent gap at 0.5-0.62 s."""
    sr = 16000
    t = np.arange(int(sr * 1.2)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.15 * np.sin(2 * np.pi * 990 * t)
    sig[int(0.5 * sr):int(0.62 * sr)] = 0.0
    return (sig * 16000).astype(np.float32), sr


def _speech(seconds, seed, sr=16000):
    """A speech-like 16-bit signal: chirp, harmonic, seeded noise, a gap."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * (200 + 300 * t + 20 * seed) * t)
    sig += 0.2 * np.sin(2 * np.pi * (800 + 30 * seed) * t)
    sig += 0.01 * rng.standard_normal(len(t))
    sig[int(0.2 * sr):int(0.25 * sr)] = 0.0
    return np.round(sig * 16000).astype(np.float32)


FIXTURES = {"tone": _verify_tone, "bench1": lambda: (bench.make_signal(1.0), 44100)}
FORMS = {"default": [], "compact": ["--compact"], "full_bank": ["--full-bank"],
         "tile128": ["--tile", "128"]}


def _both(tmp_path, args, tag):
    """Run one CLI command through both CLIs: the JAX one on paths under
    tmp/jax_<tag>, the port on paths under tmp/port_<tag> (--device cpu
    where the subcommand takes it). `args` holds '{d}' for the output
    directory. Returns (jax rc, port rc, jax dir, port dir)."""
    out = []
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        d = tmp_path / f"{name}_{tag}"
        d.mkdir(exist_ok=True)
        argv = [a.format(d=d) for a in args]
        out.append(main(argv + (extra if argv[0] in ("compress", "decompress") else [])))
        out.append(d)
    return out[0], out[2], out[1], out[3]


def _tiles(rec, bank):
    """Per range the stored tile, NaN for a sentinel."""
    return np.where((rec["idx"] >= 0)[:, None], bank[np.maximum(rec["idx"], 0)], np.nan)


def _gain64(sig, tiles, damped, s_clip=16.0):
    """float64 selection gain of each range of the signal (reflect-padded
    into ranges of the tiles' width) against its stored tile, the better
    orientation: balanced num^2 (den - N mean^2) / den^2, or damped the
    clip-aware c (2|num| - c den) where |num| > c den, else num^2 / den."""
    n = tiles.shape[1]
    r = np.pad(sig, (0, (-len(sig)) % n), mode="reflect").reshape(-1, n).astype(np.float64)
    rc = r - r.mean(1, keepdims=True)
    t = tiles.astype(np.float64)
    tm = t.mean(1)
    den = ((t - tm[:, None]) ** 2).sum(1) + 1e-12
    a = np.maximum(np.abs((rc * t).sum(1)), np.abs((rc[:, ::-1] * t).sum(1)))
    if damped:
        return np.where(a > s_clip * den, s_clip * (2 * a - s_clip * den), a * a / den)
    return a * a * (den - n * tm * tm) / den ** 2


def _assert_records_bar(jax_rb, port_rb, sig, damped=False, fp16=False):
    """The CLI bar of two (records, bank) of one signal. Ranges whose stored
    tiles differ must be ties: the two tiles' float64 gains agree (rtol
    1e-5; 2e-3 for damped, as tests/test_torch_encode.py DAMPED_RTOL: both
    packages rank damped windows in float32 sums that lose digits; the
    same for a v2 bank, whose tiles are float16). A periodic signal has
    tiles that tie exactly, broken by rounding; at most 2 per 1,024 others.
    Returns (count of differing ranges, whether records and banks are
    equal)."""
    (rec_j, bank_j), (rec_t, bank_t) = jax_rb, port_rb
    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    assert (rec_t["idx"] >= 0).any()
    tj, tt = _tiles(rec_j, bank_j), _tiles(rec_t, bank_t)
    rows = np.nonzero(~((tj == tt) | np.isnan(tj)).all(1))[0]
    gj = _gain64(sig, tj, damped)[rows]
    gt = _gain64(sig, tt, damped)[rows]
    rtol = 2e-3 if damped or fp16 else 1e-5
    tied = np.abs(gj - gt) <= rtol * np.maximum(np.abs(gj), np.abs(gt))
    assert (~tied).sum() <= near_tie.allowed_diffs(len(rec_j)), ((~tied).sum(), len(rows))
    equal = (np.array_equal(rec_t.view(np.uint8), rec_j.view(np.uint8))
             and np.array_equal(bank_t, bank_j))
    return len(rows), equal


def _assert_files_bar(jax_fwav, port_fwav, sig, damped=False):
    """_assert_records_bar of two v1/v2 files; equal records and banks
    must come with equal bytes. Returns the count of differing ranges."""
    rj, rt = load_compressed_arrays(jax_fwav), load_compressed_arrays(port_fwav)
    rows, equal = _assert_records_bar(rj[:2], rt[:2], sig, damped,
                                      fp16=Path(jax_fwav).read_bytes()[4] == 2)
    if equal:
        assert Path(port_fwav).read_bytes() == Path(jax_fwav).read_bytes()
    return rows


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_round_trip_matches_the_jax_cli(tmp_path, jax_kernel_path, fixture, form):
    sig, sr = FIXTURES[fixture]()
    wav = tmp_path / "in.wav"
    write_wav(wav, sig, sr, 2)
    rc_j, rc_t, dj, dt = _both(tmp_path, ["compress", str(wav), "{d}/x.fwav", *FORMS[form]],
                               "c")
    assert rc_j == rc_t == 0
    differ = _assert_files_bar(dj / "x.fwav", dt / "x.fwav", sig, form == "compact")
    snrs = []
    for d, main, extra in ((dj, jax_cli.main, []), (dt, port_cli.main, ["--device", "cpu"])):
        assert main(["decompress", str(d / "x.fwav"), "--out", str(d / "r.wav"), *extra]) == 0
        recon, fr, sw = read_wav_mono(d / "r.wav")
        assert (fr, sw, len(recon)) == (sr, 2, len(sig))
        snrs.append(compute_snr(sig, recon))
        if fixture == "tone":
            assert not np.abs(recon[8200:9800]).any()  # the silent gap
    assert abs(snrs[0] - snrs[1]) <= 0.01, snrs
    if fixture == "bench1" and form != "compact":  # no tie to break: the same file
        assert differ == 0
        assert (dt / "x.fwav").read_bytes() == (dj / "x.fwav").read_bytes()


#: The batch directory's files: two share a shape bucket.
SECONDS = (0.6, 0.6, 0.5, 0.7)


def _batch_dir(tmp_path, broken=True):
    d = tmp_path / "wavs"
    d.mkdir()
    for k, secs in enumerate(SECONDS):
        write_wav(d / f"f{k}.wav", _speech(secs, k), 16000, 2)
    if broken:
        (d / "broken.wav").write_bytes(b"RIFFnotawav")
    return d


def _metrics(d, name):
    return {os.path.basename(m["input"]): m for m in json.loads((d / name).read_text())}


def test_batch_matches_the_jax_cli(tmp_path, jax_kernel_path):
    """--batch: the same outputs, the JAX CLI's metrics keys per file, the
    broken file isolated with exit code 1, a rerun that skips everything
    (the metrics file untouched), and the batch decompress."""
    d = _batch_dir(tmp_path)
    rc_j, rc_t, dj, dt = _both(tmp_path, ["compress", str(d), "--batch", "--out", "{d}",
                                          "--workers", "1"], "b")
    assert rc_j == rc_t == 1
    mj, mt = _metrics(dj, "compression_metrics.json"), _metrics(dt, "compression_metrics.json")
    assert mj.keys() == mt.keys() and len(mj) == 5
    for name in mj:
        assert mj[name].keys() == mt[name].keys(), name
    assert "error" in mt["broken.wav"]
    for k, secs in enumerate(SECONDS):
        _assert_files_bar(dj / f"f{k}.wav.fwav", dt / f"f{k}.wav.fwav", _speech(secs, k))
    mtime = (dt / "compression_metrics.json").stat().st_mtime
    (d / "broken.wav").unlink()
    assert port_cli.main(["compress", str(d), "--batch", "--out", str(dt),
                          "--device", "cpu"]) == 0
    assert (dt / "compression_metrics.json").stat().st_mtime == mtime
    assert jax_cli.main(["decompress", str(dj), "--batch"]) == 0
    assert port_cli.main(["decompress", str(dt), "--batch", "--device", "cpu"]) == 0
    dmj = _metrics(dj, "decompression_metrics.json")
    dmt = _metrics(dt, "decompression_metrics.json")
    assert dmj.keys() == dmt.keys() and len(dmt) == 4
    for k, secs in enumerate(SECONDS):
        name = f"f{k}.wav.fwav"
        assert dmj[name].keys() == dmt[name].keys()
        sig = _speech(secs, k)
        a = compute_snr(sig, read_wav_mono(dmj[name]["output"])[0])
        b = compute_snr(sig, read_wav_mono(dmt[name]["output"])[0])
        assert abs(a - b) <= 0.01, (name, a, b)


def test_batch_workers_and_packed(tmp_path):
    """--workers 4 writes the bytes of --workers 1 (the threads' device
    work takes turns under DEVICE_LOCK); --batch --packed marks every file
    "packed" and writes each as the single-file encode does."""
    d = _batch_dir(tmp_path, broken=False)
    outs = {}
    for tag, extra in (("w1", ["--workers", "1"]), ("w4", ["--workers", "4"]),
                       ("packed", ["--packed"]), ("packed_compact", ["--packed", "--compact"]),
                       ("compact", ["--compact", "--workers", "3"])):
        out = tmp_path / tag
        assert port_cli.main(["compress", str(d), "--batch", "--out", str(out),
                              "--device", "cpu", *extra]) == 0
        outs[tag] = out
    names = sorted(p.name for p in outs["w1"].glob("*.fwav"))
    assert len(names) == 4
    for a, b in (("w1", "w4"), ("w1", "packed"), ("compact", "packed_compact")):
        for name in names:
            assert (outs[a] / name).read_bytes() == (outs[b] / name).read_bytes(), (a, b, name)
    for tag in ("packed", "packed_compact"):
        m = json.loads((outs[tag] / "compression_metrics.json").read_text())
        assert len(m) == 4 and all(e["packed"] is True for e in m)
        assert {"input", "output", "ratio", "packed", "time_s"} == set(m[0])


def test_packed_batch_keys_match_the_jax_cli(tmp_path, jax_kernel_path):
    d = _batch_dir(tmp_path)
    rc_j, rc_t, dj, dt = _both(tmp_path, ["compress", str(d), "--batch", "--packed",
                                          "--out", "{d}"], "p")
    assert rc_j == rc_t == 1  # the broken file
    mj, mt = _metrics(dj, "compression_metrics.json"), _metrics(dt, "compression_metrics.json")
    assert mj.keys() == mt.keys()
    for name in mj:
        assert mj[name].keys() == mt[name].keys(), name
    for k, secs in enumerate(SECONDS):
        _assert_files_bar(dj / f"f{k}.wav.fwav", dt / f"f{k}.wav.fwav", _speech(secs, k))


def _stereo(tmp_path):
    left = _speech(0.5, 1)
    other = _speech(0.5, 2)
    stereo = np.stack([left, np.round(0.7 * left + 0.3 * other)], axis=1).astype(np.float32)
    wav = tmp_path / "st.wav"
    write_wav(wav, stereo, 16000, 2)
    return wav, stereo


@pytest.mark.parametrize("mode", ["keep", "ms"])
def test_channels_match_the_jax_cli(tmp_path, jax_kernel_path, mode):
    wav, stereo = _stereo(tmp_path)
    rc_j, rc_t, dj, dt = _both(tmp_path, ["compress", str(wav), "{d}/st.fwav",
                                          "--channels", mode], "c")
    assert rc_j == rc_t == 0
    (cj, xj), (ct, xt) = load_compressed_multi(dj / "st.fwav"), load_compressed_multi(dt / "st.fwav")
    assert xj == xt and len(ct) == len(cj) == 2
    chans = multich.ms_forward(stereo) if mode == "ms" else stereo
    equal = [_assert_records_bar(a[:2], b[:2], chans[:, c], damped=True, fp16=True)[1]
             for c, (a, b) in enumerate(zip(cj, ct))]
    if all(equal):
        assert (dt / "st.fwav").read_bytes() == (dj / "st.fwav").read_bytes()
    assert port_cli.main(["decompress", str(dt / "st.fwav"), "--out", str(dt / "r.wav"),
                          "--device", "cpu"]) == 0
    assert jax_cli.main(["decompress", str(dj / "st.fwav"), "--out", str(dj / "r.wav")]) == 0
    a, b = read_wav(dj / "r.wav")[0], read_wav(dt / "r.wav")[0]
    assert a.shape == b.shape == stereo.shape
    for c in range(2):
        snr_j, snr_t = compute_snr(stereo[:, c], a[:, c]), compute_snr(stereo[:, c], b[:, c])
        assert abs(snr_j - snr_t) <= 0.01, (c, snr_j, snr_t)


def test_segment_equals_the_slice_of_the_full_decode(tmp_path):
    sig = _speech(0.8, 3)
    wav = tmp_path / "s.wav"
    write_wav(wav, sig, 16000, 2)
    for flags in ([], ["--compact"]):
        fwav = tmp_path / "s.fwav"
        assert port_cli.main(["compress", str(wav), str(fwav), "--device", "cpu", *flags]) == 0
        assert port_cli.main(["decompress", str(fwav), "--out", str(tmp_path / "full.wav"),
                              "--device", "cpu", "--eps", "0"]) == 0
        assert port_cli.main(["decompress", str(fwav), "--start", "0.2", "--duration", "0.3",
                              "--device", "cpu", "--eps", "0"]) == 0
        seg = read_wav_mono(tmp_path / "s_recon_seg_0.2s+0.3s.wav")[0]
        full = read_wav_mono(tmp_path / "full.wav")[0]
        np.testing.assert_array_equal(seg, full[3200:8000])


def _capture(capsys, main, argv):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_info_matches_the_jax_cli(tmp_path, capsys):
    wav = tmp_path / "a.wav"
    write_wav(wav, _speech(0.5, 4), 16000, 2)
    files = {}
    for tag, flags in (("v1", []), ("v2", ["--compact"])):
        files[tag] = tmp_path / f"{tag}.fwav"
        assert port_cli.main(["compress", str(wav), str(files[tag]), "--device", "cpu",
                              *flags]) == 0
    wav_st, _ = _stereo(tmp_path)
    files["v3"] = tmp_path / "v3.fwav"
    assert port_cli.main(["compress", str(wav_st), str(files["v3"]), "--channels", "ms",
                          "--device", "cpu"]) == 0
    for tag in ("v1", "v2", "v3"):
        blob = bytearray(files[tag].read_bytes())
        blob[-1] ^= 0xFF
        files[tag + "_bad_checksum"] = tmp_path / f"{tag}_bad.fwav"
        files[tag + "_bad_checksum"].write_bytes(bytes(blob))
    files["bad_header"] = tmp_path / "junk.fwav"
    files["bad_header"].write_bytes(b"NOPE" + b"\0" * 80)
    files["truncated"] = tmp_path / "trunc.fwav"
    files["truncated"].write_bytes(files["v1"].read_bytes()[:40])
    codes = {}
    for tag, path in files.items():
        for flags in ([], ["--verify"]):
            got = _capture(capsys, port_cli.main, ["info", str(path), *flags])
            want = _capture(capsys, jax_cli.main, ["info", str(path), *flags])
            assert got == want, (tag, flags)
            codes[tag, bool(flags)] = got[0]
    assert codes["v1", True] == codes["v2", True] == codes["v3", True] == 0
    assert codes["v1_bad_checksum", True] == codes["bad_header", False] == 1


def test_snr_matches_the_jax_cli(tmp_path, capsys):
    a = _speech(0.3, 5)
    b = a.copy()
    b[::50] += 100.0
    write_wav(tmp_path / "a.wav", a, 16000, 2)
    write_wav(tmp_path / "b.wav", b, 16000, 2)
    st = np.stack([a, b], axis=1)
    write_wav(tmp_path / "st.wav", st, 16000, 2)
    write_wav(tmp_path / "st2.wav", st[::-1].copy(), 16000, 2)
    for pair in (("a", "b"), ("st", "st2"), ("st", "b")):
        argv = ["snr", *(str(tmp_path / f"{p}.wav") for p in pair)]
        assert _capture(capsys, port_cli.main, argv) == _capture(capsys, jax_cli.main, argv)


def test_resume_dir_reaches_streaming(tmp_path, monkeypatch, jax_kernel_path):
    """--resume-dir reaches the streaming encoder (STREAMING_THRESHOLD
    lowered, as tests/test_cli.py does for the JAX CLI): shard checkpoints
    appear, and a rerun after losing the output reuses them for the same
    bytes, which are the JAX CLI's."""
    import fwav_tpu.models.codec as jax_codec

    from fwav_tpu_torch.models import codec

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    monkeypatch.setattr(jax_codec, "STREAMING_THRESHOLD", 8000)
    rng = np.random.default_rng(21)
    t = np.arange(24000) / 16000
    sig = np.round((0.4 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(len(t)))
                   * 16000).astype(np.float32)
    wav = tmp_path / "long.wav"
    write_wav(wav, sig, 16000, 2)
    out = tmp_path / "long.fwav"
    rd = tmp_path / "ckpt"
    argv = ["compress", str(wav), str(out), "--tile", "128", "--resume-dir", str(rd)]
    assert port_cli.main(argv + ["--device", "cpu"]) == 0
    assert sorted(rd.rglob("shard_*.npy"))
    first = out.read_bytes()
    out.unlink()
    assert port_cli.main(argv + ["--device", "cpu"]) == 0 and out.read_bytes() == first
    assert jax_cli.main(["compress", str(wav), str(tmp_path / "j.fwav"), "--tile", "128"]) == 0
    _assert_files_bar(tmp_path / "j.fwav", out, sig)


@pytest.mark.parametrize("extra", [[], ["--compact"], ["--search", "exact"]])
def test_devices_and_tp_on_cpu_cells(tmp_path, extra):
    """compress --devices 2 --tp 2 --device cpu (a (1, 2) mesh of CPU cells)
    writes the bytes of --devices 1; decompress --devices 4 runs a damped
    decode over dp 4 (the compact file's stored hint) to the SNR of one
    device's decode within 0.05 dB."""
    wav = tmp_path / "a.wav"
    sig = _speech(0.5, 11)
    write_wav(wav, sig, 16000, 2)
    outs = {}
    for devices, tp in ((1, 1), (2, 2), (4, 1)):
        out = tmp_path / f"d{devices}t{tp}.fwav"
        assert port_cli.main(["compress", str(wav), str(out), "--device", "cpu",
                              "--devices", str(devices), "--tp", str(tp), *extra]) == 0
        outs[devices, tp] = out.read_bytes()
    assert outs[2, 2] == outs[1, 1] == outs[4, 1]
    snrs = []
    for devices in (1, 4):
        recon = tmp_path / f"r{devices}.wav"
        assert port_cli.main(["decompress", str(tmp_path / "d1t1.fwav"), "--out", str(recon),
                              "--device", "cpu", "--devices", str(devices)]) == 0
        snrs.append(compute_snr(sig, read_wav_mono(recon)[0]))
    assert abs(snrs[0] - snrs[1]) < 0.05, snrs


def test_parser_validation_and_exit_codes(tmp_path, capsys):
    for argv in (["compress", "a.wav", "b.fwav", "--packed"],
                 ["compress", str(tmp_path), "--batch", "--workers", "0"],
                 ["compress", "a.wav", "b.fwav", "--devices", "4", "--tp", "3"],
                 ["compress", "a.wav"],
                 ["compress", "a.wav", "b.fwav", "--batch"],
                 ["compress", "a.wav", "b.fwav", "--channels", "ms", "--full-bank"],
                 ["compress", "a.wav", "b.fwav", "--device", "tpu"]):
        with pytest.raises(SystemExit) as e:
            port_cli.main(argv)
        assert e.value.code == 2, argv
    capsys.readouterr()
    # --devices is taken now: fewer cards than requested fails the file
    # (exit code 1), as in the JAX CLI
    wav = tmp_path / "a.wav"
    write_wav(wav, _speech(0.3, 8), 16000, 2)
    if torch.cuda.device_count() < 2:
        for argv in (["compress", str(wav), str(tmp_path / "b.fwav"), "--devices", "2"],
                     ["compress", str(wav), str(tmp_path / "b.fwav"), "--devices", "2",
                      "--tp", "2"]):
            assert port_cli.main(argv) == 1, argv
            assert not (tmp_path / "b.fwav").exists()
    assert port_cli.main(["compress", str(wav), str(tmp_path / "c.fwav"), "--device", "cpu",
                          "--compact"]) == 0
    if torch.cuda.device_count() < 8:
        assert port_cli.main(["decompress", str(tmp_path / "c.fwav"), "--out",
                              str(tmp_path / "c.wav"), "--devices", "8"]) == 1
    missing = ["compress", str(tmp_path / "missing.wav"), str(tmp_path / "o.fwav")]
    assert port_cli.main(missing + ["--device", "cpu"]) == 1
    assert port_cli.main(["decompress", str(tmp_path / "missing.fwav"), "--out",
                          str(tmp_path / "o.wav"), "--device", "cpu"]) == 1


def test_cuda_without_a_card_fails_the_file(tmp_path):
    """--device cuda is the default; without a card the file fails with
    exit code 1 and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be honoured")
    wav = tmp_path / "a.wav"
    write_wav(wav, _speech(0.3, 6), 16000, 2)
    assert port_cli.main(["compress", str(wav), str(tmp_path / "a.fwav")]) == 1
    assert not (tmp_path / "a.fwav").exists()
    assert port_cli.main(["compress", str(wav), str(tmp_path / "a.fwav"),
                          "--device", "cpu"]) == 0
    assert port_cli.main(["decompress", str(tmp_path / "a.fwav")]) == 1
    assert port_cli.main(["warmup", "--seconds", "0.1"]) == 1


def test_warmup_and_exec_cache(tmp_path):
    assert port_cli.main(["warmup", "--device", "cpu", "--seconds", "0.12", "--rate", "8000",
                          "--tile", "128", "--decode-damping", "0.25",
                          "--exec-cache", str(tmp_path / "cache")]) == 0
    assert not (tmp_path / "cache").exists()
    assert port_cli.main(["warmup", "--device", "cpu", "--seconds", "0"]) == 1
    assert port_cli.main(["warmup", "--device", "cpu", "--seconds", "1000"]) == 1


@pytest.mark.parametrize("cmd", ["info", "snr"])
def test_info_and_snr_touch_no_device(tmp_path, cmd):
    """`python -m fwav_tpu_torch info|snr` never imports the kernels'
    module nor initializes CUDA."""
    wav = tmp_path / "a.wav"
    write_wav(wav, _speech(0.3, 7), 16000, 2)
    fwav = tmp_path / "a.fwav"
    assert port_cli.main(["compress", str(wav), str(fwav), "--device", "cpu"]) == 0
    args = [str(fwav), "--verify"] if cmd == "info" else [str(wav), str(wav)]
    code = (
        "import runpy, sys, torch\n"
        f"sys.argv = ['fwav_tpu_torch', {cmd!r}, *{args!r}]\n"
        "try:\n"
        "    runpy.run_module('fwav_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.startswith('fwav_tpu_torch.ops.kernels')"
        " or m.startswith('fwav_tpu_torch.models')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)


def test_module_entry_point(tmp_path):
    wav = tmp_path / "a.wav"
    write_wav(wav, _speech(0.3, 8), 16000, 2)
    out = subprocess.run([sys.executable, "-m", "fwav_tpu_torch", "compress", str(wav),
                          str(tmp_path / "a.fwav"), "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "a.fwav").exists()
    out = subprocess.run([sys.executable, "-m", "fwav_tpu_torch"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "compress" in out.stdout


def test_file_api_signatures_are_the_jax_packages(tmp_path):
    """process_file_compress / process_file_decompress take the JAX
    package's parameters in its order, with `device` before **kwargs."""
    import inspect

    import fwav_tpu
    import fwav_tpu_torch as port

    for name in ("process_file_compress", "process_file_decompress"):
        jp = list(inspect.signature(getattr(fwav_tpu, name)).parameters.values())
        tp = list(inspect.signature(getattr(port, name)).parameters.values())
        assert [p.name for p in tp] == [p.name for p in jp[:-1]] + ["device", jp[-1].name]
        for a, b in zip(jp[:-1], tp):
            assert a.default == b.default, (name, a.name)
        assert tp[-2].default == "cuda" and tp[-1].kind == inspect.Parameter.VAR_KEYWORD
    from fwav_tpu.models import codec as jc

    from fwav_tpu_torch.models import codec as tc

    assert tc.STREAMING_THRESHOLD == jc.STREAMING_THRESHOLD
    jpk = inspect.signature(jc.process_files_compress_packed).parameters
    tpk = inspect.signature(tc.process_files_compress_packed).parameters
    assert list(tpk) == list(jpk) + ["device"]
    # devices > 1 builds the mesh of `device`'s kind: missing cards are the
    # file's error, as make_mesh raises it in the JAX package
    wav = tmp_path / "x.wav"
    write_wav(wav, _speech(0.3, 8), 16000, 2)
    if torch.cuda.device_count() < 4:
        r = tc.process_file_compress(str(wav), str(tmp_path / "x.fwav"), devices=2, tp=2)
        if torch.cuda.device_count() < 2:
            assert "requested 2 devices but only" in r["error"] and r["input"] == str(wav)
        assert all("requested 4 devices but only" in r["error"]
                   for r in tc.process_files_compress_packed([(str(wav), None)], devices=4))
    r = tc.process_file_compress(str(wav), str(tmp_path / "y.fwav"), devices=2, tp=2,
                                 device="cpu")
    assert "error" not in r, r
    one = tc.process_file_compress(str(wav), str(tmp_path / "z.fwav"), device="cpu")
    assert "error" not in one
    assert (tmp_path / "y.fwav").read_bytes() == (tmp_path / "z.fwav").read_bytes()
