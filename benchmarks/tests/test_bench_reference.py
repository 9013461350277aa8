"""The reference against the port's plain path at tiny sizes on the CPU,
the comparison's numbers, and the control that has to fail them."""

import json

import numpy as np
import pytest

import fwav_tpu_torch as port
from benchmarks import harness, pool
from benchmarks.reference import compare, v2
from benchmarks.reference import encode as ref

#: (seconds, settings) that take each plan: exact, coarse with the window
#: refine (one lobe, four lobes) and the staged refine (tile 512: a stride
#: of 64, which the window refine refuses).
PLANS = [
    (0.5, {}, ("exact", None)),
    (2.0, {}, ("coarse", "window")),
    (2.0, {"objective": "damped"}, ("coarse", "window")),
    (2.0, {"tile_size": 512}, ("coarse", "staged")),
    (2.0, {"tile_size": 512, "objective": "damped"}, ("coarse", "staged")),
]


def _signal(seconds, seed, tiny_mix):
    mix = dict(tiny_mix, pool_files=1, seconds=[seconds, seconds])
    return pool.build(mix, 44100, seed)[0].samples


@pytest.mark.parametrize("seconds,kw,want", PLANS)
def test_reference_equals_port_plain_path(seconds, kw, want, tiny_mix):
    sig = _signal(seconds, 3, tiny_mix)
    cfg = ref.Settings(**kw)
    p = ref.plan(cfg, len(sig))
    assert (p.mode, p.refine) == want
    mine = ref.encode(sig, cfg, "cpu")
    theirs = port.compress_audio_arrays(sig, 44100, 2, device="cpu", **kw)
    rec, bank = theirs[0], theirs[1]
    assert np.array_equal(mine.live, rec["idx"] >= 0)
    assert np.array_equal(mine.idx, rec["idx"].astype(np.int64))
    assert np.array_equal(mine.bank, bank)
    assert np.array_equal(mine.sym[mine.live], rec["sym"][mine.live] != 0)
    assert np.allclose(mine.s, rec["s"], rtol=1e-5, atol=1e-6)
    assert np.allclose(mine.o, rec["o"], rtol=1e-5, atol=1e-3)
    nums = compare.judge(mine, compare.from_arrays(theirs), cfg)
    assert nums["header_diff"] == nums["sentinel_diff"] == nums["bank_diff"] == 0
    assert nums["select_loss"] == 0.0 and abs(nums["fit_loss"]) < 1e-6


def test_v2_parser_reads_the_port_container(tmp_path, tiny_mix):
    from fwav_tpu_torch.models.codec import process_file_compress

    from benchmarks.entries.file_compact import write_wav16

    sig = _signal(2.0, 4, tiny_mix)
    wav = tmp_path / "a.wav"
    write_wav16(str(wav), sig, 44100)
    res = process_file_compress(str(wav), str(tmp_path), compact=True, objective="damped",
                                device="cpu")
    data = open(res["output"], "rb").read()
    c = v2.parse(data)
    rec, bank, *_ = port.load_compressed_compact(res["output"])
    assert c.hint == 0.25
    assert np.array_equal(c.live, rec["idx"] >= 0)
    assert np.array_equal(c.idx, rec["idx"][c.live])
    assert np.array_equal(c.s, rec["s"][c.live]) and np.array_equal(c.o, rec["o"][c.live])
    scale = np.float32(2.0 ** c.bank_exp)
    assert np.array_equal(c.bank_f16.view(np.float16).astype(np.float32) * scale, bank)
    cfg = ref.Settings(objective="damped")
    nums = compare.judge(ref.encode(sig, cfg, "cpu"), compare.from_container(c), cfg, 0.25)
    assert nums["header_diff"] == nums["sentinel_diff"] == nums["bank_diff"] == 0
    assert nums["select_loss"] == 0.0 and 0.0 <= nums["fit_loss"] < 0.01


def test_v2_parser_refuses_a_flipped_byte(tmp_path, tiny_mix):
    from fwav_tpu_torch.models.codec import process_file_compress

    from benchmarks.entries.file_compact import write_wav16

    wav = tmp_path / "a.wav"
    write_wav16(str(wav), _signal(1.5, 5, tiny_mix), 44100)
    res = process_file_compress(str(wav), str(tmp_path), compact=True, objective="damped",
                                device="cpu")
    data = bytearray(open(res["output"], "rb").read())
    data[-3] ^= 0x10
    with pytest.raises(ValueError):
        v2.parse(bytes(data))


@pytest.mark.parametrize("cell", ["default.speech10s", "compact.speech10s"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_the_limits(cell, seed, tiny_mix):
    """The bfloat16 control, in the codec's place, breaks a limit of the
    cell on every seed (here at a size a test run holds; benchmarks/
    control.py reads it on the card at the cell's size)."""
    from benchmarks import control

    limits = json.loads((harness.HERE / "limits" / f"{cell}.json").read_text())
    got = control.readings(cell, seed, device="cpu", mix=tiny_mix)
    assert any(got[n] > limits[n] for n in compare.NAMES), got


@pytest.mark.cuda
def test_reference_on_card_equals_cpu(card, tiny_mix):
    """The reference gives the same answer on the card as on the CPU."""
    sig = _signal(2.0, 7, tiny_mix)
    for kw in ({}, {"objective": "damped"}, {"tile_size": 512}):
        cfg = ref.Settings(**kw)
        a, b = ref.encode(sig, cfg, "cpu"), ref.encode(sig, cfg, card)
        assert np.array_equal(a.idx, b.idx) and np.array_equal(a.live, b.live)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_stream_reference_equals_port(objective, tiny_mix):
    """The streaming reference against the port's stream on the CPU, at
    shards small enough for three of them and the damped whole-file pass."""
    from fwav_tpu_torch.models.stream import compress_audio_streaming

    from benchmarks.reference import stream

    sig = _signal(3.0, 8, tiny_mix)
    cfg = ref.Settings(objective=objective)
    kw = dict(shard_samples=1 << 16, halo=1 << 14)
    theirs = compress_audio_streaming(sig, 44100, 2, device="cpu", objective=objective,
                                      global_stride=64, **kw)
    mine = stream.encode_stream(sig, cfg, "cpu", shard=kw["shard_samples"], halo=kw["halo"],
                                stride=64)
    rec = theirs[0]
    assert np.array_equal(mine.live, rec["idx"] >= 0)
    assert np.array_equal(mine.idx, rec["idx"].astype(np.int64))
    nums = compare.judge(mine, compare.from_arrays((rec, mine.bank, *theirs[2:])), cfg)
    assert nums["sentinel_diff"] == nums["bank_diff"] == nums["header_diff"] == 0
    assert nums["select_loss"] == 0.0 and abs(nums["fit_loss"]) < 1e-5
