"""The packed cell (default.clips16) on the CPU: the entry's cut of a pool
file into one call's clips, the program's packed call against the plain
reference of the same clips, a rehearsal of the cell at a small clip
size, and its two readers of the program's packing counter."""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmarks import devtrace, harness, pool
from benchmarks.entries import packed
from benchmarks.reference import compare
from benchmarks.reference import encode as ref_encode
from benchmarks.reference import packed as ref_packed

SEED = 2**31 + 1818
CELL = "default.clips16"
#: A whole clip of the rehearsal (samples): clips of 2,000-4,000 samples,
#: each over one 1,024-sample tile, so that a call stays cheap on the CPU.
SMALL_CLIP = 4000


def _bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def _config():
    return harness.find_config(_bench(), "fwav_packed_clips")


def _content(sr, seconds, seed):
    mix = harness.find_mix("clips16")
    rng = pool.rng_for(seed, 1)
    p = {k: float(rng.uniform(*mix["content"][k])) for k in pool.CONTENT}
    return pool.make_signal(seconds, sr, p, rng)


@pytest.mark.parametrize("seconds", pool.lengths(harness.find_mix("clips16")))
def test_cut_is_one_call_of_the_corpus_format(seconds):
    """Every pool file of the mix: 16 consecutive clips over the whole
    file, 14 of exactly 1 s and every clip 0.5-1.0 s at 16 kHz, the same
    for every seed at the same length."""
    n = int(16000 * seconds)
    spans = ref_packed.cut(n)
    assert len(spans) == 16 and spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    lengths = [b - a for a, b in spans]
    assert sum(k == 16000 for k in lengths) >= 14
    assert all(8000 <= k <= 16000 for k in lengths)
    sigs = [_content(16000, seconds, s) for s in (3, SEED)]
    assert [len(c) for c in ref_packed.split(sigs[0])] == \
        [len(c) for c in ref_packed.split(sigs[1])] == lengths


def test_cut_refuses_a_file_outside_the_format():
    for n in (15 * 16000 - 1, 16 * 16000 + 1):
        with pytest.raises(ValueError, match="do not cut"):
            ref_packed.cut(n)


def test_packed_call_equals_the_reference():
    """compress_audio_packed on five clips of 0.3-0.6 s at 16 kHz, over
    three shape buckets, against each clip's plain reference: the joined
    answers agree exactly on the header, the sentinels and the bank, and
    select as well as the reference; each clip alone too."""
    import fwav_tpu_torch

    config = _config()
    cfg = ref_encode.Settings(**config["encoder"])
    clips = [_content(16000, sec, SEED + k)
             for k, sec in enumerate((0.3, 0.6, 0.31, 0.45, 0.59))]
    plans = [ref_encode.plan(cfg, len(c)) for c in clips]
    assert len({(p.nb, p.mb, p.db) for p in plans}) == 3
    got = fwav_tpu_torch.compress_audio_packed(
        clips, 16000, 2, tile_size=cfg.tile_size, energy_thresh=cfg.energy_thresh,
        search=cfg.search, objective=cfg.objective, device="cpu")
    refs = [ref_encode.encode(c, cfg) for c in clips]
    for ref, res in zip(refs, got):
        nums = compare.judge(ref, compare.from_arrays(res), cfg)
        assert nums["header_diff"] == nums["sentinel_diff"] == nums["bank_diff"] == 0
        assert nums["select_loss"] == 0
    nums = compare.judge(ref_packed.join(refs),
                         packed.join([compare.from_arrays(r) for r in got]), cfg)
    assert nums["header_diff"] == nums["sentinel_diff"] == nums["bank_diff"] == 0
    assert nums["select_loss"] == 0 and nums["fit_loss"] < 1e-5


def test_join_offsets_rows_and_sums_the_header():
    """A clip's rows point into its own part of the stacked bank; a
    header field the clips disagree on is judged as wrong."""
    cfg = ref_encode.Settings(**_config()["encoder"])
    clips = [_content(16000, sec, SEED) for sec in (0.2, 0.25)]
    refs = [ref_encode.encode(c, cfg) for c in clips]
    parts = [compare.from_reference(e, cfg) for e in refs]
    both = packed.join(parts)
    assert both.header["n_ranges"] == sum(e.n_ranges for e in refs)
    assert both.header["original_len"] == sum(len(c) for c in clips)
    k = len(refs[0].bank)
    assert np.array_equal(both.bank[both.rows[parts[0].live.sum():]],
                          refs[1].bank[parts[1].rows])
    assert both.rows[parts[0].live.sum():].min() >= k
    parts[1].header["tile_size"] = 512
    nums = compare.judge(ref_packed.join(refs), packed.join(parts), cfg)
    assert nums["header_diff"] == 1


@contextlib.contextmanager
def _cpu_trace():
    yield {"cpu": True}


@pytest.fixture
def small_cell(monkeypatch):
    """The cell at SMALL_CLIP samples a clip, over two pool files, with a
    CPU stand-in for the card's trace."""
    monkeypatch.setattr(packed.Entry, "CLIP", SMALL_CLIP)
    monkeypatch.setattr(devtrace, "padded", _cpu_trace)
    monkeypatch.setattr(devtrace, "read", lambda traced: devtrace.Window(1.0, 0.0, {}, {}))
    mix = harness.find_mix("clips16")
    mix.update(pool_files=2, seconds=[15.2 * SMALL_CLIP / 16000, 15.9 * SMALL_CLIP / 16000],
               check_files=2)
    return mix


def _want(mix):
    """files_per_stack and stack_pad_share of one call of each pool file,
    from the reference's buckets (every call of a file makes the same
    stacks)."""
    cfg = ref_encode.Settings(**_config()["encoder"])
    stacks = files = valid = grid = 0
    for sec in pool.lengths(mix):
        groups = {}
        for a, b in ref_packed.cut(int(16000 * sec), SMALL_CLIP):
            p = ref_encode.plan(cfg, b - a)
            groups.setdefault((p.nb, p.mb, p.db), []).append(p)
        for ps in groups.values():
            stacks += -(-len(ps) // 16)
            files += len(ps)
            valid += sum(p.n_ranges * p.n_domains for p in ps)
            grid += sum(p.mb * p.db for p in ps)
    return files / stacks, 100.0 * (1.0 - valid / grid)


def test_rehearsal_is_correct_and_reads_the_packing(small_cell):
    out = harness.run_cell(_bench(), CELL, SEED, 1.0, True, device="cpu", mix=small_cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"files_per_stack", "stack_pad_share"}
    # the window ends inside a seeded pass over the pool, so the readings
    # are the pool files' values weighted by how often each was sent
    assert 1.0 < out["metrics"]["files_per_stack"]["value"] <= 16.0
    assert 0.0 < out["metrics"]["stack_pad_share"]["value"] < 100.0


def test_readers_match_the_buckets_over_whole_passes(small_cell):
    """Over one request of every pool file the readers give the values
    the mix's buckets give."""
    files = pool.build(small_cell, 16000, SEED)
    entry = packed.Entry(_config(), files, "", "cpu")
    reqs = []
    for f in files:
        t0 = time.perf_counter()
        entry.request(f.index)
        reqs.append(harness.Request(f.index, t0, time.perf_counter(), {}, True, False))
    run = harness.Run(reqs, None, None, files, entry)
    want_files, want_pad = _want(small_cell)
    assert harness.find_metric("files_per_stack")(run) == pytest.approx(want_files)
    assert harness.find_metric("stack_pad_share")(run) == pytest.approx(want_pad)


def test_readers_are_silent_on_a_program_without_the_counter(small_cell, monkeypatch):
    """The parent of the counter: the entry records nothing, the readers
    return None, and the run is still judged."""
    from fwav_tpu_torch.ops import kernels

    monkeypatch.delattr(kernels, "PACKS")
    out = harness.run_cell(_bench(), CELL, SEED, 0.5, True, device="cpu", mix=small_cell)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {}


def test_broken_clip_is_not_correct(small_cell, monkeypatch):
    """One clip's answer moved to another row: the joined check fails."""
    import fwav_tpu_torch

    real = fwav_tpu_torch.compress_audio_packed

    def broken(*a, **k):
        out = real(*a, **k)
        rec = out[5][0].copy()
        i = int(np.flatnonzero(rec["idx"] >= 0)[len(rec) // 3])
        rec["idx"][i] = (rec["idx"][i] + 97) % len(out[5][1])
        out[5] = (rec, *out[5][1:])
        return out

    monkeypatch.setattr(fwav_tpu_torch, "compress_audio_packed", broken)
    out = harness.run_cell(_bench(), CELL, SEED, 0.5, False, device="cpu", mix=small_cell)
    assert not out["correct"], out["checks"]


def test_control_reads_the_cell(small_cell):
    """benchmarks/control.py runs unchanged on the cell: the bfloat16
    reference fails the exact bank check."""
    from benchmarks import control

    got = control.readings(CELL, SEED, device="cpu", mix=small_cell)
    assert got["bank_diff"] > 0 and got["header_diff"] == 0


def test_kernel_calls_are_the_clips_single_calls():
    cfg = ref_encode.Settings(**_config()["encoder"])
    n = 250_000
    calls = packed.Entry.kernel_calls(cfg, n)
    assert len(calls) == 16 and all(c["kernel"] == "k1" for c in calls)
    assert sum(c["M"] for c in calls) == sum(-(-(b - a) // 4) for a, b in ref_packed.cut(n))


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmarks.reference.packed\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fwav_tpu_torch', 'fwav_tpu', 'jax', 'jaxlib', 'flax'})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
