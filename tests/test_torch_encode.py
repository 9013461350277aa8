"""The port's single-shot slice against the JAX package on the CPU: the
same signal through fwav_tpu's compress_audio_arrays with
EncoderConfig(use_pallas=True) (its kernel path, Pallas in interpret mode)
and through fwav_tpu_torch's with device="cpu" (the kernels' plain
versions), under the same settings (EncoderConfig.from_reference).

Bar: the sentinel set is identical; idx differ only at near-ties (float64
gains of both picks agree to rtol 1e-5), at most the bound stated per
case; the round-trip SNR agrees within 0.01 dB; records of rows whose idx
agree are bit-identical, and the pruned .fwav bytes are identical when all
idx agree."""

import dataclasses

import numpy as np
import pytest
import torch
from test_pallas_sharded import _sig

import bench
import chip_smoke
import fwav_tpu_torch as port
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.io.container import load_compressed_arrays as jax_load
from fwav_tpu.io.container import save_compressed as jax_save
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
from fwav_tpu.models.encode import prune_bank as jax_prune
from fwav_tpu.utils.metrics import compute_snr
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.ops import kernels

torch.set_num_threads(2)

# case -> (signal source, sample rate, config kwargs, search branch, the
# most idx that may differ). Measured: tone 85 rows (the 440 Hz tone at
# 8 kHz repeats every 200 samples, so its domains tie exactly in float64
# and float32 rounding picks among them), speechlike 0, sig66000 0,
# bench10 3.
CASES = {
    "tone": ("tone", 8000, dict(tile_size=128), "exact", 96),
    "speechlike": ("speechlike", 16000, {}, "exact", 2),
    "sig66000": ("sig66000", 16000, dict(search="coarse"), "coarse", 2),
    "bench10": ("bench10", 44100, {}, "coarse", 8),
}
_CACHE = {}


def _signal(request, source):
    if source in ("tone", "speechlike"):
        return request.getfixturevalue(source)[0]
    if source == "sig66000":
        return _sig(66000)[0]
    return bench.make_signal(10.0)


def _encode_both(request, case):
    """(signal, JAX result, port result), computed once per case."""
    if case not in _CACHE:
        source, sr, kw, _, _ = CASES[case]
        sig = _signal(request, source)
        jcfg = JaxEncoderConfig(use_pallas=True, **kw)
        cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
        _CACHE[case] = (
            sig,
            jax_encode(sig, sr, 2, config=jcfg),
            port.compress_audio_arrays(sig, sr, 2, config=cfg, device="cpu"),
        )
    return _CACHE[case]


def _gains(sig, n, bank, idx, rows):
    """float64 balanced gains of bank rows idx for the raw ranges rows."""
    pad = (-len(sig)) % n
    r = np.pad(sig, (0, pad), mode="reflect").reshape(-1, n)[rows].astype(np.float64)
    rc = r - r.mean(1, keepdims=True)
    b = bank[idx].astype(np.float64)
    dm = b.mean(1)
    den = ((b - dm[:, None]) ** 2).sum(1)
    w = (den - n * dm * dm) / (den + 1e-12) ** 2
    no, nm = (rc * b).sum(1), (rc[:, ::-1] * b).sum(1)
    return np.maximum(no * no * w, nm * nm * w)


def _snr(sig, res, decode, **kw):
    rec, bank, n_ranges, range_size, *_ = res
    return compute_snr(sig, decode(rec, bank, n_ranges, range_size,
                                   original_len=len(sig), **kw))


@pytest.mark.parametrize("case", list(CASES))
def test_slice_matches_jax(request, case, tmp_path):
    sig, J, T = _encode_both(request, case)
    _, sr, kw, branch, max_diffs = CASES[case]
    rec_j, bank_j, n_ranges, range_size, *_ = J
    rec_t, bank_t, *_ = T
    assert tuple(J[2:]) == tuple(T[2:])
    np.testing.assert_array_equal(bank_t, bank_j)
    cfg = EncoderConfig(**kw)
    assert port_encode._resolve_search(cfg, range_size, port.utils.bucket(len(bank_j), 256))[0] == branch

    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    diff = np.nonzero(rec_t["idx"] != rec_j["idx"])[0]
    assert len(diff) <= max_diffs, len(diff)
    if len(diff):
        np.testing.assert_allclose(
            _gains(sig, range_size, bank_j, rec_t["idx"][diff], diff),
            _gains(sig, range_size, bank_j, rec_j["idx"][diff], diff), rtol=1e-5,
        )
    same = rec_t["idx"] == rec_j["idx"]
    np.testing.assert_array_equal(rec_t[same].view(np.uint8), rec_j[same].view(np.uint8))

    snr_j = _snr(sig, J, jax_decode)
    snr_t = _snr(sig, T, port.decompress_audio, device="cpu")
    assert abs(snr_t - snr_j) <= 0.01, (snr_t, snr_j)

    if not len(diff):
        paths = []
        for name, prune, save, res in (("jax", jax_prune, jax_save, J),
                                       ("port", port.prune_bank, port.save_compressed, T)):
            rec, bank = prune(res[0], res[1])
            paths.append(tmp_path / f"{name}.fwav")
            save(str(paths[-1]), rec, bank, range_size, sr, 2, *res[4:])
        assert paths[0].read_bytes() == paths[1].read_bytes()


def test_bench_constants_of_chip_smoke(request):
    """chip_smoke.py holds the 10 s slice to the JAX CPU kernel-path run's
    numbers; re-derive them here so they cannot drift."""
    sig, J, T = _encode_both(request, "bench10")
    assert J[2] == chip_smoke.SLICE_RANGES
    assert int((J[0]["idx"] < 0).sum()) == chip_smoke.SLICE_SENTINELS
    assert abs(_snr(sig, J, jax_decode) - chip_smoke.SLICE_SNR_DB) <= 5e-5
    assert int((T[0]["idx"] < 0).sum()) == chip_smoke.SLICE_SENTINELS
    snr_t = _snr(sig, T, port.decompress_audio, device="cpu")
    assert abs(snr_t - chip_smoke.SLICE_SNR_DB) <= chip_smoke.SNR_TOL_DB


def test_cross_decode_bit_equal(speechlike, tmp_path):
    """A .fwav written by either package loads and decodes bit-equal in the
    other."""
    sig, sr, sw = speechlike
    J = jax_encode(sig, sr, sw, config=JaxEncoderConfig(use_pallas=True))
    T = port.compress_audio_arrays(sig, sr, sw, device="cpu")
    for name, res, prune, save in (("jax", J, jax_prune, jax_save),
                                   ("port", T, port.prune_bank, port.save_compressed)):
        rec, bank = prune(res[0], res[1])
        path = str(tmp_path / f"{name}.fwav")
        save(path, rec, bank, res[3], sr, sw, *res[4:])
        lj, lt = jax_load(path), port.load_compressed_arrays(path)
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        out_j = jax_decode(lj[0], lj[1], lj[2], lj[3], original_len=lj[9])
        out_t = port.decompress_audio(lt[0], lt[1], lt[2], lt[3],
                                      original_len=lt[9], device="cpu")
        np.testing.assert_array_equal(out_t, out_j)


def test_cpu_run_launches_no_kernel(speechlike):
    kernels.reset_launch_counts()
    sig, sr, sw = speechlike
    port.compress_audio_arrays(sig, sr, sw, device="cpu")
    assert kernels.LAUNCHES == {"search_scan": 0, "refine_window": 0}


@pytest.mark.parametrize("kw,match", [
    (dict(objective="damped", search="coarse"), "K3"),
    (dict(search="coarse", coarse_topc=2), "K3"),
    (dict(search="topk"), "topk"),
    (dict(search="coarse", tile_size=256), "staged refine"),
])
def test_unported_geometry_raises(kw, match):
    """What the JAX package runs outside its two kernels raises, naming the
    ROADMAP item, instead of running something else."""
    sig = _sig(40000)[0]
    with pytest.raises(NotImplementedError, match=match):
        port.compress_audio_arrays(sig, 16000, 2, config=EncoderConfig(**kw), device="cpu")


def test_means_cap_raises():
    """Banks over the refine's 9 MB means cap (~53 s at 44.1 kHz) take the
    staged refine in the JAX package; the port raises."""
    cfg = EncoderConfig()
    # the bank buckets on either side of the cap: 8 MiB and 10 MiB of means
    assert port_encode._plan_search(cfg, 1 << 21, 2097152) == ("coarse", 128)
    with pytest.raises(NotImplementedError, match="9 MB"):
        port_encode._plan_search(cfg, 1 << 21, 2621440)


def test_damped_decode_raises(speechlike):
    sig, sr, sw = speechlike
    rec, bank, n, rs, *_ = port.compress_audio_arrays(sig, sr, sw, device="cpu")
    with pytest.raises(NotImplementedError, match="damped"):
        port.decompress_audio(rec, bank, n, rs, s_damping=0.25, device="cpu")
