"""Whole runs on the CPU at a tiny size, the check for a card skipped:
sound runs come out correct, runs with the codec broken underneath do not."""

import numpy as np
import pytest

import fwav_tpu_torch
from benchmarks import harness
from benchmarks.entries import file_compact
from fwav_tpu_torch.models import codec

SEED = 2**31 + 4242


def _bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def _alter_one(result):
    """One live range's answer changed where it is produced: another row."""
    rec = result[0].copy()
    i = int(np.flatnonzero(rec["idx"] >= 0)[len(rec) // 3])
    rec["idx"][i] = (rec["idx"][i] + 997) % len(result[1])
    return (rec, *result[1:])


def _drop_half(result):
    """Every other live range left out (made a sentinel)."""
    rec = result[0].copy()
    live = np.flatnonzero(rec["idx"] >= 0)[::2]
    rec["idx"][live] = -1
    return (rec, *result[1:])


@pytest.mark.parametrize("cell", ["default.speech10s", "compact.speech10s"])
def test_sound_run_is_correct(cell, tiny_mix):
    out = harness.run_cell(_bench(), cell, SEED, 1.0, False, device="cpu", mix=tiny_mix)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-2] == "checks"  # the checks come last in the printed line


@pytest.mark.parametrize("fault", [_alter_one, _drop_half])
@pytest.mark.parametrize("cell", ["default.speech10s", "compact.speech10s"])
def test_broken_codec_is_not_correct(cell, fault, tiny_mix, monkeypatch):
    real = fwav_tpu_torch.compress_audio_arrays

    def broken(*a, **k):
        return fault(real(*a, **k))

    monkeypatch.setattr(fwav_tpu_torch, "compress_audio_arrays", broken)
    monkeypatch.setattr(codec, "compress_audio_arrays", broken)
    out = harness.run_cell(_bench(), cell, SEED, 1.0, False, device="cpu", mix=tiny_mix)
    assert not out["correct"], out["checks"]


def test_unreadable_container_is_not_correct(tiny_mix):
    class Garbled(file_compact.Entry):
        def request(self, i):
            super().request(i)
            with open(self.latest[i], "r+b") as f:
                f.seek(80)
                f.write(b"\x00\x01")

    out = harness.run_cell(_bench(), "compact.speech10s", SEED, 1.0, False, device="cpu",
                           mix=tiny_mix, entry_cls=Garbled)
    assert not out["correct"]


class _ShortStream(file_compact.Entry):
    """The file API with its streaming threshold lowered to 2^16 samples,
    so that a tiny file takes the stream (one shard at this length)."""

    STREAM_ABOVE = 1 << 16


@pytest.mark.parametrize("fault", [None, _alter_one, _drop_half])
def test_stream_cell_faults(fault, tiny_mix, monkeypatch):
    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", _ShortStream.STREAM_ABOVE)
    if fault is not None:
        real = codec.compress_audio_streaming

        def broken(*a, **k):
            res = real(*a, **k)
            bank = np.zeros((int(res[0]["idx"].max()) + 1, res[3]), np.float32)
            return fault((res[0], bank, *res[2:]))[:1] + res[1:]

        monkeypatch.setattr(codec, "compress_audio_streaming", broken)
    out = harness.run_cell(_bench(), "compact.stream110s", SEED, 1.0, False, device="cpu",
                           mix=tiny_mix,
                           entry_cls=_ShortStream)
    assert out["correct"] == (fault is None), out["checks"]
