"""The port's streaming encode against the JAX package on the CPU: the same
signal through fwav_tpu's compress_audio_streaming and through
fwav_tpu_torch's with device="cpu" (the kernels' plain versions), under the
same settings (EncoderConfig.from_reference).

Fixtures:
- mid: bench.make_signal(12.0) at 44.1 kHz, shards of 2^17 samples with
  halos of 2^15: 5 shards whose 196,608-row window banks take the coarse
  kernel path (K1 then K2 balanced, K3 then K2 once over its lobes damped), and a
  damped global pass whose nomination runs on K3. The JAX side runs its
  kernel path (EncoderConfig(use_pallas=True), Pallas in interpret mode).
  Bar: identical sentinel sets; at most 2 differing idx per 1,024 rows,
  each a near-tie (float64 gains for balanced, the damped float32 window
  score of tests/test_torch_encode.py for damped); bit-identical records
  wherever idx agree; round-trip SNR within 0.01 dB; the damped hinted
  decode through v2 within 0.01 dB with the same iterations; identical v1
  bytes from the streaming writer and v2 bytes from the pruned container
  when every idx agrees.
- small: the JAX package's tests/test_global_candidates.py fixture (tile
  128: the exact branch in every shard, then the pass).

The behaviour cases hold the port to the JAX package's own streaming and
global-pass tests."""

import dataclasses

import numpy as np
import pytest
import torch
from test_global_candidates import KW as SMALL_KW
from test_global_candidates import _sig as small_sig
from test_torch_encode import _damped_scores32, _gains

import bench
import chip_smoke
import fwav_tpu_torch as port
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.io.compact import parse_decode_hint as jax_parse_hint
from fwav_tpu.io.compact import save_compressed_compact as jax_save_compact
from fwav_tpu.io.container import load_compressed_arrays as jax_load
from fwav_tpu.io.container import save_compressed_streaming as jax_save_streaming
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
from fwav_tpu.models.encode import remap_matches as jax_remap
from fwav_tpu.models.stream import compress_audio_streaming as jax_stream
from fwav_tpu.models.stream import domain_block_iter as jax_blocks
from fwav_tpu.ops.domains import bank_rows_host as jax_rows
from fwav_tpu.ops.search import refine_from_lobes as jax_refine
from fwav_tpu.utils.metrics import compute_snr
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.io import native as port_native
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.models import stream as port_stream
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.ops.domains import build_domains_host, n_domains_for
from fwav_tpu_torch.ops.search import refine_from_lobes

torch.set_num_threads(2)

MID = dict(shard_samples=1 << 17, halo=1 << 15)
SMALL = {k: v for k, v in SMALL_KW.items() if k in ("shard_samples", "halo")}
SMALL_CFG = {k: v for k, v in SMALL_KW.items() if k not in SMALL}
# case -> (signal, rate, config kwargs, stream kwargs, the JAX kernel path)
CASES = {
    "mid_balanced": ("mid", 44100, dict(objective="balanced"), MID, True),
    "mid_damped": ("mid", 44100, dict(objective="damped"), MID, True),
    "small_damped": ("small", 8000, SMALL_CFG, SMALL, False),
}
#: Near-tie bar of the damped picks' float32 window scores (as in
#: tests/test_torch_encode.py; the shards normalize by their window's
#: max|x|, the score here by the file's).
DAMPED_RTOL = 2e-3
_CACHE = {}


def _signal(name):
    return bench.make_signal(12.0) if name == "mid" else small_sig()[0]


def _stream_both(case):
    """(signal, JAX result, port result, port stats), once per case."""
    if case not in _CACHE:
        name, sr, kw, skw, kernel_path = CASES[case]
        sig = _signal(name)
        jcfg = JaxEncoderConfig(use_pallas=kernel_path, **kw)
        cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
        stats = {}
        _CACHE[case] = (
            sig,
            jax_stream(sig, sr, 2, config=jcfg, **skw),
            port.compress_audio_streaming(sig, sr, 2, config=cfg, device="cpu",
                                          stats=stats, **skw),
            stats,
        )
    return _CACHE[case]


def _full_bank(sig, res):
    return build_domains_host(sig, res[4], res[3], res[5])


def _records_snr(sig, res, decode, **kw):
    rec, _, n_ranges, rs, *_ = res
    return compute_snr(sig, decode(rec, _full_bank(sig, res), n_ranges, rs,
                                   original_len=len(sig), **kw))


@pytest.mark.parametrize("case", ["mid_balanced", "mid_damped"])
def test_mid_fixture_matches_jax(case, tmp_path):
    sig, J, T, stats = _stream_both(case)
    _, sr, kw, _, _ = CASES[case]
    rec_j, rec_t = J[0], T[0]
    assert T[1] is None and tuple(J[2:]) == tuple(T[2:])
    n = T[3]
    assert len(stats["shards"]) == 5
    assert ("global_pass" in stats) == (kw["objective"] == "damped")

    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    diff = np.nonzero(rec_t["idx"] != rec_j["idx"])[0]
    assert len(diff) <= 2 * -(-len(rec_j) // 1024), len(diff)
    if len(diff) and kw["objective"] == "damped":
        np.testing.assert_allclose(
            _damped_scores32(sig, n, diff, rec_t["idx"][diff]),
            _damped_scores32(sig, n, diff, rec_j["idx"][diff]), rtol=DAMPED_RTOL,
        )
    elif len(diff):
        bank = _full_bank(sig, T)
        np.testing.assert_allclose(_gains(sig, n, bank, rec_t["idx"][diff], diff),
                                   _gains(sig, n, bank, rec_j["idx"][diff], diff), rtol=1e-5)
    same = rec_t["idx"] == rec_j["idx"]
    np.testing.assert_array_equal(rec_t[same].view(np.uint8), rec_j[same].view(np.uint8))

    damping = 0.25 if kw["objective"] == "damped" else 0.0
    snr_j = _records_snr(sig, J, jax_decode, s_damping=damping)
    snr_t = _records_snr(sig, T, port.decompress_audio, s_damping=damping, device="cpu")
    assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)

    # the streaming v1 writers: the same bytes from the same records, so
    # the same file wherever every idx agrees
    rec, _, nr, rs, tile, step, thr, olen = T
    for name, save, blocks in (("jax", jax_save_streaming, jax_blocks),
                               ("port", port.save_compressed_streaming,
                                port_stream.domain_block_iter)):
        save(str(tmp_path / f"{name}.fwav"), rec, blocks(sig, tile, rs, step),
             n_domains_for(olen, tile, step), rs, sr, 2, tile, step, thr, olen)
    assert (tmp_path / "jax.fwav").read_bytes() == (tmp_path / "port.fwav").read_bytes()


def _jax_prune_streamed(rec, sig, tile, rs, step):
    """The JAX package's models/codec.py _streamed_pruned recipe."""
    used = np.unique(rec["idx"][rec["idx"] >= 0])
    return jax_remap(rec, used), jax_rows(sig, tile, rs, step, used)


def _hinted_decode(tmp_path, name, sig, sr, res, prune, save, hint, load, decode, **kw):
    """The streaming prune, v2 with the damped profile's decode hint, load,
    and the decode at the stored hint. Returns (SNR, stats, file bytes)."""
    rec, _, _, rs, tile, step, thr, olen = res
    prec, bank = prune(rec, sig, tile, rs, step)
    path = tmp_path / f"{name}.fwav"
    save(str(path), prec, bank, rs, sr, 2, tile, step, thr, olen,
         decode_damping=port.DAMPED_DECODE_DAMPING)
    damping = hint(path.read_bytes()[:128])
    assert damping == 0.25
    lrec, lbank, nr, lrs, *_, lolen = load(str(path))
    stats = {}
    out = decode(lrec, lbank, nr, lrs, original_len=lolen, s_damping=damping, stats=stats, **kw)
    return compute_snr(sig, out), stats, path.read_bytes()


@pytest.mark.parametrize("case", ["mid_damped", "small_damped"])
def test_damped_hinted_decode_matches_jax(case, tmp_path):
    """The damped streaming profile as users get it: the streaming prune,
    v2 with the hint, the decode loop at the stored hint."""
    sig, J, T, _ = _stream_both(case)
    sr = CASES[case][1]
    snr_j, st_j, bytes_j = _hinted_decode(
        tmp_path, "jax", sig, sr, J, _jax_prune_streamed, jax_save_compact, jax_parse_hint,
        jax_load, jax_decode)
    snr_t, st_t, bytes_t = _hinted_decode(
        tmp_path, "port", sig, sr, T, port_stream._prune_streamed, port.save_compressed_compact,
        port.parse_decode_hint, port.load_compressed_arrays, port.decompress_audio,
        device="cpu")
    assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)
    assert st_t["iterations"] == st_j["iterations"] and st_t["converged"] == st_j["converged"]
    # the pruned v2 container: the same bytes from the same records
    _, _, bytes_tj = _hinted_decode(
        tmp_path, "port_by_jax", sig, sr, T, _jax_prune_streamed, jax_save_compact,
        jax_parse_hint, jax_load, jax_decode)
    assert bytes_tj == bytes_t
    if np.array_equal(J[0]["idx"], T[0]["idx"]):
        assert bytes_t == bytes_j


def test_small_fixture_matches_jax():
    """The exact branch in every shard, then the pass. Its differing idx
    are exact ties of the refit: rows in and around the fixture's silent
    gap, where near-flat tiles give every candidate the same residual."""
    sig, J, T, stats = _stream_both("small_damped")
    rec_j, rec_t = J[0], T[0]
    assert tuple(J[2:]) == tuple(T[2:])
    assert len(stats["shards"]) == 3 and stats["global_pass"]["improved"] > 0
    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    diff = rec_t["idx"] != rec_j["idx"]
    assert diff.mean() <= 0.01, diff.sum()
    np.testing.assert_allclose(rec_t["err"][diff], rec_j["err"][diff], rtol=1e-5)
    snr_j = _records_snr(sig, J, jax_decode, s_damping=0.25)
    snr_t = _records_snr(sig, T, port.decompress_audio, s_damping=0.25, device="cpu")
    assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)


def test_cpu_stream_launches_no_kernel():
    kernels.reset_launch_counts()
    sig, sr = small_sig(seconds=1.0, seed=5)
    port.compress_audio_streaming(sig, sr, 2, device="cpu", **SMALL_KW)
    assert not any(kernels.LAUNCHES.values())


# --- behaviour cases, each the port side of a JAX package test ------------------


def _small(sig, sr, **kw):
    return port.compress_audio_streaming(sig, sr, 2, device="cpu", **{**SMALL_KW, **kw})


def _decode_snr(sig, res):
    rec, _, n_ranges, rs, *_ = res
    return compute_snr(sig, port.decompress_audio(
        rec, _full_bank(sig, res), n_ranges, rs, original_len=res[7], s_damping=0.25,
        device="cpu"))


def _auto_gate(monkeypatch, tmp_path):
    """test_global_candidates.py::test_global_pass_auto_gate."""
    sig, sr = small_sig()
    on, off = _small(sig, sr), _small(sig, sr, global_candidates=False)
    np.testing.assert_array_equal(_small(sig, sr, global_candidates=True)[0], on[0])
    assert np.any(on[0]["idx"] != off[0]["idx"])
    base = _small(sig, sr, objective="balanced")
    np.testing.assert_array_equal(
        base[0], _small(sig, sr, objective="balanced", global_candidates=False)[0])


def _never_resurrects_and_improves(monkeypatch, tmp_path):
    """test_global_candidates.py::test_global_pass_winners_strictly_improve."""
    sig, sr = small_sig(seconds=1.0, seed=11)
    rec_on, rec_off = _small(sig, sr)[0], _small(sig, sr, global_candidates=False)[0]
    changed = rec_on["idx"] != rec_off["idx"]
    assert changed.any()
    assert not (changed & (rec_off["idx"] < 0)).any()
    worse = changed & (rec_on["err"] > rec_off["err"] + 1e-4)
    assert worse.mean() < 0.05, worse.mean()


def _int32_protocol(monkeypatch, tmp_path):
    """test_global_candidates.py::test_global_pass_int32_protocol_branch."""
    sig, sr = small_sig()
    on = _small(sig, sr)
    monkeypatch.setattr(port_encode, "PACK3_MAX_ROWS", 0)
    np.testing.assert_array_equal(_small(sig, sr)[0], on[0])


def _stride_valve(monkeypatch, tmp_path):
    """test_global_candidates.py::test_global_pass_auto_stride_valve."""
    sig, sr = small_sig(seconds=1.0, seed=5)
    monkeypatch.setattr(port_stream, "GLOBAL_NOM_ROWS", 2)
    stats = {}
    on = _small(sig, sr, stats=stats)
    off = _small(sig, sr, global_candidates=False)
    assert stats["global_pass"]["stride"] > 512
    assert np.any(on[0]["idx"] != off[0]["idx"])
    assert _decode_snr(sig, on) >= _decode_snr(sig, off) - 1e-6


def _budget_skip(monkeypatch, tmp_path):
    """test_global_candidates.py::test_global_pass_device_budget_skip."""
    sig, sr = small_sig()
    off = _small(sig, sr, global_candidates=False)
    monkeypatch.setattr(port_stream, "GLOBAL_PASS_MAX_ROWS", 1)
    stats = {}
    np.testing.assert_array_equal(_small(sig, sr, stats=stats)[0], off[0])
    assert "global_pass" not in stats


def _resume(monkeypatch, tmp_path):
    """test_streaming.py::test_streaming_shard_resume and
    test_global_candidates.py::test_global_pass_resume: a rerun encodes
    only the shards without a checkpoint, and the pass reruns."""
    sig, sr = small_sig()
    ck = tmp_path / "ck"
    first = _small(sig, sr, resume_dir=str(ck))
    files = sorted(ck.rglob("shard_*.npy"))
    assert len(files) == 3
    files[-1].unlink()
    calls = []
    orig = port_stream.encode_core_masked
    monkeypatch.setattr(port_stream, "encode_core_masked",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    np.testing.assert_array_equal(_small(sig, sr, resume_dir=str(ck))[0], first[0])
    assert len(calls) == 1
    np.testing.assert_array_equal(first[0], _small(sig, sr)[0])


def _fingerprint(monkeypatch, tmp_path):
    """test_streaming.py::test_shared_resume_dir_isolates_inputs_and_params."""
    ck = str(tmp_path / "shared")
    kw = dict(tile_size=128, shard_samples=4096, halo=2048)
    sig_a, sr = small_sig(seed=3)
    sig_b, _ = small_sig(seed=4)
    rec_a = _small(sig_a, sr, resume_dir=ck, **kw)[0]
    rec_b = _small(sig_b, sr, resume_dir=ck, **kw)[0]
    np.testing.assert_array_equal(rec_b, _small(sig_b, sr, **kw)[0])
    assert not np.array_equal(rec_a, rec_b)
    rec_a2 = _small(sig_a, sr, resume_dir=ck, objective="affine", **kw)[0]
    np.testing.assert_array_equal(rec_a2, _small(sig_a, sr, objective="affine", **kw)[0])
    assert len({p.parent for p in (tmp_path / "shared").rglob("shard_*.npy")}) == 3


def _all_silent(monkeypatch, tmp_path):
    """The all-silent early return: the empty result, as in the JAX package."""
    sig = np.zeros(20000, np.float32)
    got = _small(sig, 8000)
    want = jax_stream(sig, 8000, 2, **SMALL_KW)
    assert len(got[0]) == 0 and got[2] == 0 and got[1].shape == (0, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _domain_blocks(monkeypatch, tmp_path):
    """test_streaming.py::test_domain_block_iter_matches_reference_builder:
    the blocks are the host bank's rows, and the JAX package's blocks."""
    sig = small_sig(seconds=0.5)[0]
    got = np.concatenate(list(port_stream.domain_block_iter(sig, 128, 4, 1, block_rows=777)))
    np.testing.assert_array_equal(got, build_domains_host(sig, 128, 4, 1))
    np.testing.assert_array_equal(
        got, np.concatenate(list(jax_blocks(sig, 128, 4, 1, block_rows=777))))


BEHAVIOUR = {f.__name__.lstrip("_"): f for f in (
    _auto_gate, _never_resurrects_and_improves, _int32_protocol, _stride_valve,
    _budget_skip, _resume, _fingerprint, _all_silent, _domain_blocks,
)}


@pytest.mark.parametrize("case", list(BEHAVIOUR))
def test_streaming_behaviour(case, monkeypatch, tmp_path):
    BEHAVIOUR[case](monkeypatch, tmp_path)


# --- the API --------------------------------------------------------------------


def _reference_kwargs():
    return dict(tile_size=1024, emb_dim=8, top_k=16, ef_search=10, use_gpu=True,
                energy_thresh=2e-4, domains_tmpdir="/nonexistent", batch_size_gpu=7,
                batch_size_cpu=3, fast_mode=True, transient_weight=0.5, n_mels=20,
                cpu_workers=2, search="auto", objective="balanced",
                global_candidates=True)


def test_compress_audio_arrays_takes_the_jax_kwargs(speechlike):
    """The file API passes one kwarg set to the single-shot and the
    streaming encoders; the port takes the JAX package's whole set and
    gives its records."""
    sig, sr, sw = speechlike
    kw = _reference_kwargs()
    J = jax_encode(sig, sr, sw, **kw)
    T = port.compress_audio_arrays(sig, sr, sw, device="cpu", **kw)
    np.testing.assert_array_equal(T[0].view(np.uint8), J[0].view(np.uint8))
    np.testing.assert_array_equal(T[1], J[1])
    assert tuple(T[2:]) == tuple(J[2:])


def test_streaming_takes_the_jax_kwargs():
    sig, sr = small_sig(seconds=1.0, seed=5)
    kw = {**_reference_kwargs(), "tile_size": 128, "objective": "damped"}
    J = jax_stream(sig, sr, 2, shard_samples=4096, halo=2048, **kw)
    T = port.compress_audio_streaming(sig, sr, 2, shard_samples=4096, halo=2048,
                                      device="cpu", **kw)
    np.testing.assert_array_equal(T[0]["idx"] < 0, J[0]["idx"] < 0)
    assert tuple(T[2:]) == tuple(J[2:])
    with pytest.raises(TypeError, match="unknown compress kwargs"):
        port.compress_audio_streaming(sig, sr, 2, device="cpu", shard_size=4096)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        port.compress_audio_streaming(sig, sr, 2, device="cpu", mesh=object())


def test_prep_signal_names_streaming():
    """Past 2^24 bank rows the single-shot encode sends the caller to the
    streaming encoder."""
    cfg = EncoderConfig(tile_size=256)  # range 4, step 1
    sig = np.zeros((1 << 24) + 256, np.float32)
    with pytest.raises(ValueError, match="compress_audio_streaming"):
        port_encode._prep_signal(sig, cfg)


def test_streaming_writer_bytes(tmp_path, monkeypatch):
    """save_compressed_streaming writes save_compressed's bytes (native
    writer and its Python fallback), and the JAX package's streaming
    writer's."""
    sig, sr = small_sig(seconds=0.4)
    rec, bank, nr, rs, tile, step, thr, olen = port.compress_audio_arrays(
        sig, sr, 2, tile_size=128, device="cpu")
    paths = [tmp_path / f"{k}.fwav" for k in ("plain", "port", "jax", "fallback")]
    port.save_compressed(paths[0], rec, bank, rs, sr, 2, tile, step, thr, olen)
    with monkeypatch.context() as mp:
        mp.setattr(port_native, "write", lambda *a: False)
        port.save_compressed(paths[3], rec, bank, rs, sr, 2, tile, step, thr, olen)
    port.save_compressed_streaming(paths[1], rec,
                                   port_stream.domain_block_iter(sig, tile, rs, step, 100),
                                   len(bank), rs, sr, 2, tile, step, thr, olen)
    jax_save_streaming(str(paths[2]), rec, jax_blocks(sig, tile, rs, step, 100), len(bank),
                       rs, sr, 2, tile, step, thr, olen)
    assert len({p.read_bytes() for p in paths}) == 1
    with pytest.raises(ValueError, match="yielded"):
        port.save_compressed_streaming(tmp_path / "bad.fwav", rec, iter([bank[:5]]),
                                       len(bank), rs, sr, 2, tile, step, thr, olen)
    assert not list(tmp_path.glob("bad.fwav*"))


# --- the staged window refine ----------------------------------------------------


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("stride,top_c", [(512, 1), (64, 1), (16, 2)])
def test_refine_from_lobes_matches_jax(objective, stride, top_c):
    """Two-stage (16, 4) for W >= 64, (8,) below, and the dense window
    of C lobes; lobes of -1 and past the valid rows, a bank with padding
    rows (balanced padding scores 0 and must not win)."""
    rng = np.random.default_rng(stride + top_c)
    M, N, D, n_valid = 700, 4, 12 * stride + 4096, 11 * stride + 301
    x = np.cumsum(rng.standard_normal(D + 64)).astype(np.float32) * 0.05
    bank = np.stack([x[j * 16 : j * 16 + D] for j in range(N)], axis=1)
    bank[n_valid:] = 0.0
    ranges = (rng.standard_normal((M, N)) * 0.3).astype(np.float32)
    coarse = rng.integers(-1, D // stride + 1, (M, top_c)).astype(np.int32)
    i_j, *_, s_j = jax_refine(ranges, bank, np.arange(D) < n_valid, coarse, stride, 2.0,
                              objective, return_score=True)
    i_t, s_t = refine_from_lobes(torch.from_numpy(ranges), torch.from_numpy(bank), n_valid,
                                 torch.from_numpy(coarse), stride, 2.0, objective)
    i_j, s_j = np.asarray(i_j), np.asarray(s_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t.numpy()), fin)
    assert (i_t.numpy()[fin] < n_valid).all()
    np.testing.assert_array_equal(i_t.numpy()[fin], i_j[fin])
    np.testing.assert_allclose(s_t.numpy()[fin], s_j[fin], rtol=1e-5)


def test_argmax_keeps_the_first_max():
    """The staged refine's picks rely on argmax over the K axis of a (K, M)
    score taking the first of exact ties, as jnp.argmax does."""
    s = torch.tensor([[1.0, float("-inf"), 3.0], [2.0, float("-inf"), 3.0],
                      [2.0, float("-inf"), 1.0]])
    assert s.argmax(0).tolist() == [1, 0, 0]


# --- the 100 s constants of chip_smoke.py ----------------------------------------


@pytest.mark.slow
def test_stream_constants_of_chip_smoke(tmp_path):
    """chip_smoke.py holds the 100 s streaming paths to the JAX package's
    CPU run on its kernel path; re-derive its numbers (several minutes)."""
    sig, sr = bench.make_signal(100.0), 44100
    got = {}
    for gc in (None, False):
        cfg = JaxEncoderConfig(use_pallas=True, objective="damped", global_candidates=gc)
        res = jax_stream(sig, sr, 2, config=cfg)
        got[gc] = _hinted_decode(tmp_path, "jax", sig, sr, res, _jax_prune_streamed,
                                 jax_save_compact, jax_parse_hint, jax_load, jax_decode)
        assert res[2] == chip_smoke.STREAM_RANGES
        assert int((res[0]["idx"] < 0).sum()) == chip_smoke.STREAM_SENTINELS
    snr, stats, data = got[None]
    assert abs(snr - chip_smoke.STREAM_DAMPED_SNR_DB) <= 5e-5
    assert stats["iterations"] == chip_smoke.STREAM_DAMPED_ITERATIONS
    assert len(data) == chip_smoke.STREAM_DAMPED_COMPACT_BYTES_JAX
    assert abs(got[False][0] - chip_smoke.STREAM_DAMPED_OFF_SNR_DB) <= 5e-5

    res = jax_stream(sig, sr, 2, config=JaxEncoderConfig(use_pallas=True))
    rec, _, nr, rs, tile, step, thr, olen = res
    assert int((rec["idx"] < 0).sum()) == chip_smoke.STREAM_SENTINELS
    path = tmp_path / "balanced.fwav"
    nd = n_domains_for(olen, tile, step)
    jax_save_streaming(str(path), rec, jax_blocks(sig, tile, rs, step), nd, rs, sr, 2, tile,
                       step, thr, olen)
    assert path.stat().st_size == chip_smoke.STREAM_BALANCED_V1_BYTES
    lrec, lbank, ln, lrs, *_, lolen = jax_load(str(path))
    snr = compute_snr(sig, jax_decode(lrec, lbank, ln, lrs, original_len=lolen))
    assert abs(snr - chip_smoke.STREAM_BALANCED_SNR_DB) <= 5e-5
