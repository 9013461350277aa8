"""The port's single-shot slice against the JAX package on the CPU: the
same signal through fwav_tpu's compress_audio_arrays with
EncoderConfig(use_pallas=True) (its kernel path, Pallas in interpret mode)
and through fwav_tpu_torch's with device="cpu" (the kernels' plain
versions), under the same settings (EncoderConfig.from_reference).

Bar: the sentinel set is identical; idx differ only at near-ties, at most
the bound stated per case (float64 gains of both picks agree to rtol 1e-5;
for the damped cases, the float32 window scores the refine kernels rank
by, see _damped_scores32); the round-trip SNR agrees within 0.01 dB;
records of rows whose idx agree are bit-identical, and the pruned .fwav
bytes (v1 and v2) are identical when all idx agree. The damped cases also
decode through the v2 container at its stored hint: within 0.01 dB, with
the same iteration count."""

import dataclasses

import numpy as np
import pytest
import torch
from test_pallas_sharded import _sig

import bench
import chip_smoke
import fwav_tpu_torch as port
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.io.compact import parse_decode_hint as jax_parse_hint
from fwav_tpu.io.compact import save_compressed_compact as jax_save_compact
from fwav_tpu.io.container import load_compressed_arrays as jax_load
from fwav_tpu.io.container import save_compressed as jax_save
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
from fwav_tpu.models.encode import prune_bank as jax_prune
from fwav_tpu.ops.domains import box_sums as jax_box_sums
from fwav_tpu.utils.metrics import compute_snr
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.ops import kernels

torch.set_num_threads(2)

# case -> (signal source, sample rate, config kwargs, search branch, the
# most idx that may differ). Measured: tone 85 rows (the 440 Hz tone at
# 8 kHz repeats every 200 samples, so its domains tie exactly in float64
# and float32 rounding picks among them), speechlike 0, sig66000 0,
# bench10 3, sig66000_topc2 1, sig66000_damped 3, bench10_damped 82 (2 per
# 1,024 rows is 216). The multi-lobe cases run K3, then K2 once over all lobes.
CASES = {
    "tone": ("tone", 8000, dict(tile_size=128), "exact", 96),
    "speechlike": ("speechlike", 16000, {}, "exact", 2),
    "sig66000": ("sig66000", 16000, dict(search="coarse"), "coarse", 2),
    "bench10": ("bench10", 44100, {}, "coarse", 8),
    "sig66000_topc2": ("sig66000", 16000, dict(search="coarse", coarse_topc=2), "coarse", 4),
    "sig66000_damped": ("sig66000", 16000, dict(search="coarse", objective="damped"),
                        "coarse", 8),
    "bench10_damped": ("bench10", 44100, dict(objective="damped"), "coarse", 216),
}
DAMPED = [c for c in CASES if CASES[c][2].get("objective") == "damped"]
#: Near-tie bar of the damped picks' float32 window scores. The damped
#: score of a near-flat window divides by a float32 sum of squares that
#: has lost most of its digits, so the two packages' refine kernels,
#: which sum in their own orders, rank such windows differently, and on
#: exact ties in the lobe scan the TPU kernel keeps another lobe than K3
#: (ops/kernels.py topc_scan_ref). Measured on bench10_damped: 78 of the
#: 82 differing rows agree to 4e-7, the worst to 1.8e-3.
DAMPED_RTOL = 2e-3
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


def _damped_scores32(sig, n, rows, pos, c=16.0, B=256):
    """float32 damped window score of bank position pos[i] for range
    rows[i], in the order of operations of the refine kernels, from the
    box means of the normalized signal (the JAX package's box_sums)."""
    inv = np.float32(1.0) / np.abs(sig).max()
    means = np.asarray(jax_box_sums(sig * inv, B)) * np.float32(1.0 / B)
    r = (np.pad(sig, (0, (-len(sig)) % n), mode="reflect") * inv).reshape(-1, n)[rows]
    rc = r - (r.sum(1, dtype=np.float32) / np.float32(n))[:, None]
    v = [means[pos + j * B] for j in range(n)]
    mean = sum(v[1:], v[0]) * np.float32(1.0 / n)
    no, nm = rc[:, 0] * v[0], rc[:, n - 1] * v[0]
    for j in range(1, n):
        no, nm = no + rc[:, j] * v[j], nm + rc[:, n - 1 - j] * v[j]
    den = sum(((vj - mean) * (vj - mean) for vj in v), np.zeros_like(mean))
    a, th = np.maximum(np.abs(no), np.abs(nm)), np.float32(c) * den
    return np.where(a > th, np.float32(c) * (np.float32(2) * a - th),
                    a * a / (den + np.float32(1e-12)))


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
    if len(diff) and case in DAMPED:
        np.testing.assert_allclose(
            _damped_scores32(sig, range_size, diff, rec_t["idx"][diff]),
            _damped_scores32(sig, range_size, diff, rec_j["idx"][diff]), rtol=DAMPED_RTOL,
        )
    elif len(diff):
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
        for saves in ((jax_save, port.save_compressed),
                      (jax_save_compact, port.save_compressed_compact)):
            paths = []
            for name, prune, save, res in (("jax", jax_prune, saves[0], J),
                                           ("port", port.prune_bank, saves[1], T)):
                rec, bank = prune(res[0], res[1])
                paths.append(tmp_path / f"{name}.fwav")
                save(str(paths[-1]), rec, bank, range_size, sr, 2, *res[4:])
            assert paths[0].read_bytes() == paths[1].read_bytes()


def _hinted_decode(tmp_path, name, res, sr, prune, save, hint, load, decode, **kw):
    """Prune, write v2 with the damped profile's decode hint, read it back
    and decode at the stored hint. Returns (recon, stats, file bytes)."""
    rec, bank = prune(res[0], res[1])
    path = tmp_path / f"{name}.fwav"
    save(str(path), rec, bank, res[3], sr, 2, *res[4:],
         decode_damping=port.DAMPED_DECODE_DAMPING)
    damping = hint(path.read_bytes()[:128])
    assert damping == 0.25
    lrec, lbank, n, rs, *_, olen = load(str(path))
    stats = {}
    out = decode(lrec, lbank, n, rs, original_len=olen, s_damping=damping, stats=stats, **kw)
    return out, stats, path.stat().st_size


@pytest.mark.parametrize("case", DAMPED)
def test_damped_hinted_decode_matches_jax(request, case, tmp_path):
    """The damped profile as users get it: v2 with the hint, decoded by the
    loop at s_damping=0.25 (ROADMAP Queue 1 item 6's bar)."""
    sig, J, T = _encode_both(request, case)
    sr = CASES[case][1]
    out_j, st_j, _ = _hinted_decode(tmp_path, "jax", J, sr, jax_prune, jax_save_compact,
                                    jax_parse_hint, jax_load, jax_decode)
    out_t, st_t, _ = _hinted_decode(tmp_path, "port", T, sr, port.prune_bank,
                                    port.save_compressed_compact, port.parse_decode_hint,
                                    port.load_compressed_arrays, port.decompress_audio,
                                    device="cpu")
    assert abs(compute_snr(sig, out_t) - compute_snr(sig, out_j)) <= 0.01
    assert st_t["iterations"] == st_j["iterations"] and st_t["converged"] == st_j["converged"]
    # the hint is what makes the profile: far above its damping=0 decode
    assert compute_snr(sig, out_t) > _snr(sig, T, port.decompress_audio, device="cpu") + 10


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


def test_damped_constants_of_chip_smoke(request, tmp_path):
    """The damped slice's numbers in chip_smoke.py, from the JAX CPU
    kernel-path run: the records decoded at 0.25, and the main path through
    v2 with the hint (its iterations and bytes)."""
    sig, J, T = _encode_both(request, "bench10_damped")
    assert J[2] == chip_smoke.SLICE_RANGES
    assert int((J[0]["idx"] < 0).sum()) == chip_smoke.DAMPED_SENTINELS
    stats = {}
    snr = _snr(sig, J, jax_decode, s_damping=0.25, stats=stats)
    assert abs(snr - chip_smoke.DAMPED_RECORDS_SNR_DB) <= 5e-5
    assert stats["iterations"] == chip_smoke.DAMPED_ITERATIONS and stats["converged"]
    out, stats, size = _hinted_decode(tmp_path, "jax", J, 44100, jax_prune, jax_save_compact,
                                      jax_parse_hint, jax_load, jax_decode)
    assert abs(compute_snr(sig, out) - chip_smoke.DAMPED_SNR_DB) <= 5e-5
    assert stats["iterations"] == chip_smoke.DAMPED_ITERATIONS
    assert size == chip_smoke.DAMPED_COMPACT_BYTES_JAX
    assert int((T[0]["idx"] < 0).sum()) == chip_smoke.DAMPED_SENTINELS
    out, stats, _ = _hinted_decode(tmp_path, "port", T, 44100, port.prune_bank,
                                   port.save_compressed_compact, port.parse_decode_hint,
                                   port.load_compressed_arrays, port.decompress_audio,
                                   device="cpu")
    assert abs(compute_snr(sig, out) - chip_smoke.DAMPED_SNR_DB) <= chip_smoke.SNR_TOL_DB
    assert stats["iterations"] == chip_smoke.DAMPED_ITERATIONS


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
    assert not any(kernels.LAUNCHES.values())
    port.compress_audio_arrays(sig, sr, sw, device="cpu",
                               config=EncoderConfig(search="coarse", objective="damped"))
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("kw,match", [
    (dict(objective="damped", search="coarse", tile_size=512), "staged refine"),
    (dict(search="coarse", coarse_topc=2, tile_size=512), "staged refine"),
    (dict(search="topk"), "topk"),
    (dict(search="coarse", tile_size=256), "staged refine"),
])
def test_unported_geometry_raises(kw, match):
    """What the JAX package runs outside its kernels raises, naming the
    ROADMAP item, instead of running something else: with several lobes,
    a coarse stride under 128 (tile 512) fails the window refine's gate,
    and the JAX package runs coarse_refine_search there."""
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


def test_multi_lobe_gate_matches_jax():
    """The port runs K3 then K2 exactly where the JAX package's multi-lobe
    kernel branch runs (its refine_blocks_ok gate at the bucketed bank),
    and raises where that branch hands over to coarse_refine_search."""
    from fwav_tpu.ops.pallas_search import refine_blocks_ok as jax_gate

    from fwav_tpu_torch.models.encode import _pow2_divisor

    for tile, objective, mb, db in [(1024, "damped", 20480, 65536),
                                    (1024, "damped", 114688, 458752),
                                    (1024, "damped", 1 << 21, 2621440),
                                    (512, "damped", 20480, 65536),
                                    (2048, "balanced", 20480, 65536)]:
        cfg = EncoderConfig(tile_size=tile, objective=objective, search="coarse",
                            coarse_topc=4)
        stride = port_encode._resolve_search(cfg, cfg.range_size, db)[1]
        rblk = _pow2_divisor(mb, cfg.range_block)
        ok = jax_gate(rblk, _pow2_divisor(rblk, 512), stride, cfg.domain_step, 4,
                      objective, db)
        if ok:
            assert port_encode._plan_search(cfg, mb, db) == ("coarse", stride)
        else:
            with pytest.raises(NotImplementedError, match="staged refine"):
                port_encode._plan_search(cfg, mb, db)
