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
from fwav_tpu_torch.io import native as port_native
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.models import refit
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.ops.domains import build_domains_host
from fwav_tpu_torch.parallel import Mesh, compress_audio_sharded
from fwav_tpu_torch.utils.buckets import bucket
from fwav_tpu_torch.utils.trace import collect_phases
from native_libs import ensure_native_libraries

ensure_native_libraries()

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


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_integer_samples_build_the_bank_as_the_device_does(monkeypatch, dtype):
    """An int16 array, and whole-valued float32, reach the program as int16,
    and their bank comes from bank_means (its plain version here): the
    records and the bank's bits of the host path, which a float stack
    takes (_as_i16_or_f32 patched to ship float32)."""
    sig = bench.make_signal(1.5).astype(dtype)
    kernels.reset_launch_counts()
    got = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
    assert kernels.BANK_BUILDS == {"device": 1, "host": 0}
    with monkeypatch.context() as m:
        m.setattr(port_encode, "_as_i16_or_f32", lambda s, nb=None: (s, False))
        want = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
    assert kernels.BANK_BUILDS == {"device": 1, "host": 1}
    assert not any(kernels.LAUNCHES.values())
    assert got[1].dtype == np.float32 and got[1].flags.c_contiguous
    np.testing.assert_array_equal(got[1].view(np.uint32), want[1].view(np.uint32))
    np.testing.assert_array_equal(got[0].view(np.uint8), want[0].view(np.uint8))
    assert tuple(got[2:]) == tuple(want[2:])


def test_float_samples_build_the_bank_on_the_host(speechlike):
    """Samples that are no whole numbers keep build_domains_host."""
    sig, sr, sw = speechlike
    kernels.reset_launch_counts()
    res = port.compress_audio_arrays(sig, sr, sw, device="cpu")
    assert kernels.BANK_BUILDS == {"device": 0, "host": 1}
    np.testing.assert_array_equal(
        res[1].view(np.uint32),
        build_domains_host(sig, 1024, 4, 1).view(np.uint32))


def _i16_valued(n: int) -> np.ndarray:
    """n int16 sample values as float32, the full range but -32768 among them."""
    rng = np.random.default_rng(n)
    return np.clip(np.round(rng.standard_normal(n) * 9000), -32767, 32767).astype(np.float32)


def _with(n: int, at, value) -> np.ndarray:
    sig = _i16_valued(n)
    sig[at] = value
    return sig


# case -> (the caller's samples, whether they ship as int16)
PROBE_CASES = {
    "nan": (lambda: _with(9000, 4500, np.nan), False),
    "+inf": (lambda: _with(9000, 4500, np.inf), False),
    "-inf": (lambda: _with(9000, 4500, -np.inf), False),
    "-32768": (lambda: _with(9000, 4500, -32768.0), False),
    "32767": (lambda: _with(9000, [0, 4500, 8999], 32767.0), True),
    "32767.5": (lambda: _with(9000, 4500, 32767.5), False),
    "half_first": (lambda: _with(9000, 0, 0.5), False),
    "half_last": (lambda: _with(9000, 8999, 0.5), False),
    "-0.0": (lambda: _with(9000, slice(100, 700), -0.0), True),
    "length_1": (lambda: _i16_valued(1), True),
    "length_2x4096": (lambda: _i16_valued(2 * 4096), True),
    "length_2x4096_plus_1": (lambda: _i16_valued(2 * 4096 + 1), True),
    "half_past_2x4096": (lambda: _with(2 * 4096 + 1, 2 * 4096, 0.5), False),
    "float64_caller": (lambda: _i16_valued(9000).astype(np.float64), True),
    "float64_caller_fraction": (lambda: _i16_valued(9000).astype(np.float64) + 0.25, False),
    "int16_caller": (lambda: _i16_valued(9000).astype(np.int16), True),
    "int16_caller_-32768": (lambda: _with(9000, 10, -32768.0).astype(np.int16), False),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_native_probe_equals_the_numpy_spec(monkeypatch, case):
    """The native one-pass probe (native/prep.cpp) and its numpy spec give
    the same decision, dtype and padded row on the samples as
    compress_audio_arrays hands them on (float32), and the decision is the
    one each case states."""
    make, want_i16 = PROBE_CASES[case]
    sig = np.ascontiguousarray(np.asarray(make(), dtype=np.float32))
    nb = bucket(len(sig), 4096)
    before = dict(port_encode.PREPS)
    got, got_i16 = port_encode._as_i16_or_f32(sig, nb)
    assert port_encode.PREPS["fallback"] == before["fallback"]  # the native pass ran
    with monkeypatch.context() as m:
        m.setattr(port_native, "_load_prep", lambda: None)
        want, spec_i16 = port_encode._as_i16_or_f32(sig, nb)
    assert port_encode.PREPS["fallback"] == before["fallback"] + 1
    assert got_i16 == spec_i16 == want_i16
    assert got.dtype == want.dtype == (np.int16 if want_i16 else np.float32)
    assert got.shape == want.shape == ((nb,) if want_i16 else sig.shape)
    assert got.tobytes() == want.tobytes()
    spec_row, spec_i16 = port_encode._i16_spec(sig, nb)
    assert spec_i16 == want_i16
    if want_i16:
        assert spec_row.tobytes() == got.tobytes() and not got[len(sig):].any()
    else:
        assert got is sig


@pytest.mark.parametrize("dp,tp,search", [(1, 1, "exact"), (2, 1, "exact"), (1, 2, "exact"),
                                          (1, 2, "coarse"), (2, 2, "coarse")])
@pytest.mark.parametrize("dtype", ["int16_valued", "float"])
def test_prep_signal_pads_for_a_mesh_as_before(monkeypatch, dp, tp, search, dtype):
    """_prep_signal's counts, buckets and padded row at every mesh padding:
    the same from the native pass and from the numpy spec, and the row the
    samples zero-padded to the 4096 bucket in the transfer dtype."""
    sig = _i16_valued(70_000)
    if dtype == "float":
        sig = sig / 32768.0
    cfg = EncoderConfig(search=search)
    got = port_encode._prep_signal(sig, cfg, dp, tp)
    with monkeypatch.context() as m:
        m.setattr(port_native, "_load_prep", lambda: None)
        want = port_encode._prep_signal(sig, cfg, dp, tp)
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype and got[0].tobytes() == want[0].tobytes()
    nb = bucket(len(sig), 4096)
    row = np.zeros(nb, dtype=np.int16 if dtype == "int16_valued" else np.float32)
    row[: len(sig)] = sig
    assert got[0].dtype == row.dtype and got[0].tobytes() == row.tobytes()


@pytest.mark.parametrize("case,want", [
    ("int16_valued", {"int16": 1, "float32": 0, "fallback": 0}),
    ("unit_floats", {"int16": 0, "float32": 1, "fallback": 0}),
    ("with_-32768", {"int16": 0, "float32": 1, "fallback": 0}),
    ("no_library", {"int16": 1, "float32": 0, "fallback": 1}),
])
def test_preps_counts_the_transfer_dtype(monkeypatch, case, want):
    """PREPS counts each file by the dtype it ships in, and the passes that
    ran the numpy spec; without the native library the encode's records
    and bank are the same bytes."""
    sig = bench.make_signal(1.5)
    if case == "unit_floats":
        sig = sig / 32768.0
    elif case == "with_-32768":
        sig[777] = -32768.0
    before = dict(port_encode.PREPS)
    with monkeypatch.context() as m:
        if case == "no_library":
            m.setattr(port_native, "_load_prep", lambda: None)
        got = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
    assert {k: port_encode.PREPS[k] - before[k] for k in want} == want
    if case == "no_library":
        want_res = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
        np.testing.assert_array_equal(got[0].view(np.uint8), want_res[0].view(np.uint8))
        np.testing.assert_array_equal(got[1].view(np.uint32), want_res[1].view(np.uint32))
        assert tuple(got[2:]) == tuple(want_res[2:])


def test_device_bank_keeps_the_host_sign_of_zero():
    """A float signal that opens with -0.0 samples: the host build's first
    mean is -0.0 (its float64 sums keep the sign), which int16 samples
    cannot carry; the device path gives the same bits."""
    sig = bench.make_signal(1.5)
    sig[:600] = -0.0
    kernels.reset_launch_counts()
    res = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
    assert kernels.BANK_BUILDS == {"device": 1, "host": 0}
    want = build_domains_host(sig, 1024, 4, 1)
    neg_zero = (want == 0) & np.signbit(want)
    assert neg_zero[0, 0] and neg_zero.sum() == 1
    np.testing.assert_array_equal(res[1].view(np.uint32), want.view(np.uint32))


def test_packed_stack_builds_each_bank_on_the_device():
    """A packed stack of two int16 files with different domain counts: one
    bank_means call for the stack, each file's bank its host build."""
    base = bench.make_signal(1.6)
    sigs = [base, base[:68000].copy()]
    kernels.reset_launch_counts()
    res = port.compress_audio_packed(sigs, 44100, 2, device="cpu")
    assert kernels.BANK_BUILDS == {"device": 2, "host": 0}
    assert len({len(r[1]) for r in res}) == 2
    for sig, r in zip(sigs, res):
        np.testing.assert_array_equal(
            r[1].view(np.uint32),
            build_domains_host(sig, 1024, 4, 1).view(np.uint32))


class _FakeMesh:
    """What models/refit.py card_refit_mode reads of a mesh, for devices
    this machine may not have."""

    def __init__(self, device, size=1, multi_process=False):
        self.device, self.size, self.multi_process = torch.device(device), size, multi_process

    def first_local_device(self):
        return self.device


@pytest.mark.parametrize("dtype,fast_mode,mesh,check,want,bank", [
    (np.int16, True, _FakeMesh("cuda"), 1, 1, "device"),
    (np.int16, True, _FakeMesh("cuda"), 2, 2, "device"),
    (np.float32, True, _FakeMesh("cuda"), 1, None, "host"),
    (np.int16, False, _FakeMesh("cuda"), 1, None, "device"),
    (np.int16, True, _FakeMesh("cpu"), 1, None, "device"),
    (np.int16, True, _FakeMesh("cuda", size=2), 1, None, "device"),
    (np.int16, True, _FakeMesh("cuda", multi_process=True), 1, None, "device"),
], ids=["int16", "int16_vector8", "float", "no_fast_mode", "cpu", "two_cells",
        "two_processes"])
def test_card_refit_engages_by_what_it_observes(monkeypatch, dtype, fast_mode, mesh, check,
                                                want, bank):
    """The refit runs on the card for an int16 stack under fast_mode on a
    one-cell CUDA mesh of this process, in the self-check's variant; every
    other stack keeps the host refit (None). The same HostHalf builds the
    bank of an int16 stack with bank_means ("device", its plain version on
    these CPU samples) and of a float one on the host, whatever the mesh."""
    monkeypatch.setattr(refit, "refit_mode", lambda device, n: check)
    cfg = EncoderConfig(fast_mode=fast_mode)
    assert refit.card_refit_mode(np.dtype(dtype), cfg, mesh) == want
    sig = bench.make_signal(0.25)
    if dtype == np.float32:
        sig = sig + np.float32(0.25)
    raw_p, n_ranges, n_domains, _, _ = port_encode._prep_signal(sig, cfg)
    assert raw_p.dtype == dtype
    kernels.reset_launch_counts()
    half = refit.HostHalf(torch.from_numpy(raw_p[None]), [(sig, raw_p, n_ranges, n_domains)],
                          cfg, mesh)
    assert half.mode == want and kernels.BANK_BUILDS[bank] == 1


@pytest.mark.parametrize("host", ["bits_differ", "no_native_library"])
def test_refit_self_check_raises_where_the_card_cannot_give_the_host_bits(monkeypatch, host):
    """Where no variant gives the native refit's records (here one bit of
    one record's err differs), or the native library is missing, the
    self-check raises (on the CPU its launches take the plain version): a
    stack that meets the rest of the rule is not handed back to the host
    refit. Nothing is cached, and the launch count is as it was."""

    def records(case, n, s_clip):
        if host == "no_native_library":
            return None
        want = real(case, n, s_clip)
        err = want[1]["err"].view(np.uint32)
        err[3] ^= 1
        return want

    real = refit.host_records
    monkeypatch.setattr(refit, "host_records", records)
    monkeypatch.setattr(refit, "_modes", {})
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="native"):
        refit.refit_mode("cpu", 4)
    assert refit._modes == {} and kernels.LAUNCHES["collect_refit"] == 0


@pytest.mark.parametrize("case", ["float", "no_fast_mode", "cpu", "two_cells"])
def test_host_refit_cases_count_under_host(case):
    """A float stack, fast_mode=False, the CPU device and a two-cell mesh
    each refit on the host and count their file under REFITS["host"]; no
    collect_refit runs."""
    sig = bench.make_signal(1.5)
    kernels.reset_launch_counts()
    if case == "two_cells":
        compress_audio_sharded(sig, 44100, 2, mesh=Mesh([["cpu"] * 2]))
    else:
        if case == "float":
            sig = sig + np.float32(0.25)
        port.compress_audio_arrays(sig, 44100, 2, device="cpu",
                                   fast_mode=case != "no_fast_mode")
    assert kernels.REFITS == {"device": 0, "host": 1}
    assert not any(kernels.LAUNCHES.values())


def _card_refit_on_the_cpu(monkeypatch):
    """Route int16 stacks under fast_mode through the card refit's path
    with CPU tensors (collect_refit's plain version, no pinned copy)."""
    monkeypatch.setattr(refit, "card_refit_mode",
                        lambda dtype, cfg, mesh: kernels.REFIT_FUSED
                        if dtype == np.int16 and cfg.fast_mode else None)


def test_card_refit_path_gives_the_host_records(monkeypatch):
    """The card refit's path (its records, views into one buffer a stack,
    and the live and bad counts) on the CPU: a single file and a packed
    stack of three lengths and an all-silent file give the host path's
    records byte for byte and its empty result, count under
    REFITS["device"], and still time the host half's `refit`."""
    base = bench.make_signal(1.6)
    sigs = [base, base[:68000].copy(), bench.make_signal(1.2), np.zeros(50000, np.float32)]
    want = [port.compress_audio_arrays(s, 44100, 2, device="cpu") for s in sigs]
    _card_refit_on_the_cpu(monkeypatch)
    kernels.reset_launch_counts()
    with collect_phases() as ph:
        one = port.compress_audio_arrays(sigs[0], 44100, 2, device="cpu")
    assert kernels.REFITS == {"device": 1, "host": 0} and ph["refit"] > 0
    assert one[0].tobytes() == want[0][0].tobytes()
    packed = port.compress_audio_packed(sigs, 44100, 2, device="cpu")
    assert kernels.REFITS == {"device": 5, "host": 0}
    for got, w in zip(packed, want):
        assert got[0].dtype == w[0].dtype and got[0].tobytes() == w[0].tobytes()
        assert tuple(got[2:]) == tuple(w[2:])
    assert len(packed[3][0]) == 0


def test_card_refit_path_records_match_jax(request, monkeypatch):
    """The card refit's path (collect_refit's plain version, on the CPU)
    on the 10 s bench signal: the host path's records byte for byte, held
    to the JAX package's run at the Encode bar (agreeing rows bit for
    bit)."""
    sig, J, T = _encode_both(request, "bench10")
    _, sr, kw, _, max_diffs = CASES["bench10"]
    cfg = EncoderConfig.from_reference(dataclasses.asdict(JaxEncoderConfig(use_pallas=True,
                                                                           **kw)))
    _card_refit_on_the_cpu(monkeypatch)
    kernels.reset_launch_counts()
    got = port.compress_audio_arrays(sig, sr, 2, config=cfg, device="cpu")
    assert kernels.REFITS == {"device": 1, "host": 0}
    assert got[0].tobytes() == T[0].tobytes()
    _assert_encode_bar(sig, J, got, cfg, max_diffs)


def test_card_refit_raises_for_a_code_past_the_bank():
    """collect_refit's plain version counts a code at or past its file's
    rows as bad and gives it the sentinel record; the host half raises
    the native refit's IndexError for such a file."""
    case = refit.check_case(4, 7)
    codes = case.codes.copy()
    nd = case.n_domains[2]
    codes[2, 5] = [nd & 0xFF, (nd >> 8) & 0xFF, nd >> 16]
    out = kernels.collect_refit(*(torch.from_numpy(a) for a in (codes, case.x, case.bank)),
                                [len(s) for s in case.signals], case.n_domains, 4, 16.0)
    parts = kernels.split_records(out.numpy(), [-(-len(s) // 4) for s in case.signals])
    assert [p[2] for p in parts] == [0, 0, 1] and parts[2][0]["idx"][5] == -1
    want = refit.host_records(case, 4, 16.0)
    for p, w in zip(parts[:2], want[:2]):
        assert p[0].tobytes() == w.tobytes() and p[1] == int((w["idx"] >= 0).sum())
    sig = case.signals[2]
    with pytest.raises(IndexError, match="out of range"):
        refit._card_result(parts[2], sig, EncoderConfig(), len(parts[2][0]),
                           case.host_banks[2])


def _assert_encode_bar(sig, J, T, cfg, max_diffs):
    """The Encode bar: the same sentinel set; idx equal except at near-ties
    (float64 balanced gains to rtol 1e-5; for damped the float32 window
    scores to DAMPED_RTOL), at most max_diffs of them; records of agreeing
    rows bit-identical; round-trip SNR within 0.01 dB. Returns the count of
    differing rows."""
    rec_j, bank_j, n_ranges, range_size, *_ = J
    rec_t, bank_t, *_ = T
    assert tuple(J[2:]) == tuple(T[2:])
    np.testing.assert_array_equal(bank_t, bank_j)
    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    assert (rec_t["idx"] >= 0).any()
    diff = np.nonzero(rec_t["idx"] != rec_j["idx"])[0]
    assert len(diff) <= max_diffs, len(diff)
    if len(diff) and cfg.objective == "damped":
        assert cfg.domain_step == 1
        B = cfg.tile_size // range_size
        np.testing.assert_allclose(
            _damped_scores32(sig, range_size, diff, rec_t["idx"][diff], B=B),
            _damped_scores32(sig, range_size, diff, rec_j["idx"][diff], B=B),
            rtol=DAMPED_RTOL,
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
    return len(diff)


def _staged_parity(sig, sr, kw, refine="staged"):
    """One signal through both packages on a geometry whose coarse refine
    is `refine` in the port's plan; held to the Encode bar, 2 differing
    rows per 1,024 at most."""
    jcfg = JaxEncoderConfig(use_pallas=True, **kw)
    cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
    _, _, _, lb, db = port_encode._prep_signal(sig, cfg)
    plan = port_encode._plan_search(cfg, lb // cfg.range_size, db)
    assert plan[0] == "coarse" and plan[2] == refine, plan
    kernels.reset_launch_counts()
    J = jax_encode(sig, sr, 2, config=jcfg)
    T = port.compress_audio_arrays(sig, sr, 2, config=cfg, device="cpu")
    assert not any(kernels.LAUNCHES.values())
    return _assert_encode_bar(sig, J, T, cfg, 2 * -(-J[2] // 1024))


@pytest.mark.parametrize("kw,match", [
    (dict(objective="damped", search="coarse", tile_size=512), "staged refine"),
    (dict(search="coarse", coarse_topc=2, tile_size=512), "staged refine"),
    (dict(search="topk"), "topk"),
    (dict(search="coarse", tile_size=256), "staged refine"),
])
def test_unported_geometry_raises(kw, match):
    """What used to raise now runs where the JAX package runs it, held to
    the JAX CPU run: search="topk" (the embedding shortlist, at the topk
    bar of tests/test_torch_topk.py), and the geometries of the staged
    refine (a coarse stride under 128 fails the window refine's gate:
    stride 64 at tile 512, with four damped lobes or two balanced ones, and
    stride 32 at tile 256 with one lobe) at the Encode bar."""
    sig = _sig(40000)[0]
    if match == "topk":
        from test_torch_topk import assert_topk_bar

        J = jax_encode(sig, 16000, 2, config=JaxEncoderConfig(**kw))
        T = port.compress_audio_arrays(sig, 16000, 2, config=EncoderConfig(**kw), device="cpu")
        assert_topk_bar(sig, J, T)
        return
    _staged_parity(sig, 16000, kw)


def test_staged_tile_2048_matches_jax():
    """Tile 2048 gives range size 8 and domain_step 2, which the window
    refine's gate refuses: K1, then the staged refine over the full bank."""
    _staged_parity(_sig(66000)[0], 16000, dict(search="coarse", tile_size=2048))


#: Range sizes over 16 (tiles from 4352): K1 and K3 take their wide kernels
#: on the card (csrc/scan_wide.cuh), whose plain versions run here. name ->
#: (seconds of bench.make_signal, config kwargs, plan). On 3 s, tile 8192
#: (N = 32, domain_step 8) has a 16,384-row bank: "auto" takes the exact
#: branch; "coarse" takes the staged refine (domain_step > 1), after K1 or,
#: damped, K3's four lobes. Tile 16384 (N = 64) and tile 4352 (N = 17) alike.
WIDE = {
    "tile8192": (3.0, dict(tile_size=8192), ("exact", 128, None)),
    "tile8192_damped": (3.0, dict(tile_size=8192, objective="damped", search="coarse"),
                        ("coarse", 128, "staged")),
    "tile8192_coarse": (3.0, dict(tile_size=8192, search="coarse"), ("coarse", 128, "staged")),
    "tile16384": (3.0, dict(tile_size=16384), ("exact", 128, None)),
    "tile4352_coarse": (2.0, dict(tile_size=4352, search="coarse"), ("coarse", 128, "staged")),
}


@pytest.mark.parametrize("case", list(WIDE))
def test_wide_tile_matches_jax(case):
    """Tiles of 4352 and more (range sizes 17 to 64) through both packages
    at the Encode bar (2 differing rows per 1,024 at most). Measured: 0
    differing rows at tiles 8192 and 16384, 6 of 5,189 at tile 4352."""
    seconds, kw, plan = WIDE[case]
    sig = bench.make_signal(seconds)
    jcfg = JaxEncoderConfig(use_pallas=True, **kw)
    cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
    assert cfg.range_size > 16
    _, _, _, lb, db = port_encode._prep_signal(sig, cfg)
    assert port_encode._plan_search(cfg, lb // cfg.range_size, db) == plan
    kernels.reset_launch_counts()
    J = jax_encode(sig, 44100, 2, config=jcfg)
    T = port.compress_audio_arrays(sig, 44100, 2, config=cfg, device="cpu")
    assert not any(kernels.LAUNCHES.values())
    _assert_encode_bar(sig, J, T, cfg, 2 * -(-J[2] // 1024))


@pytest.fixture
def small_means_cap(monkeypatch):
    """The window refine's means cap lowered to 64 KB in both packages, so
    that a 4 s file's bank is over it. The JAX core is cached per config
    (lru_cache, jit) and reads the cap when it is traced, so the tests that
    use this take configs no other test uses (s_clip 15.5)."""
    import fwav_tpu.ops.pallas_search as jax_kernels

    monkeypatch.setattr(jax_kernels, "_REFINE_VMEM_MEANS_BYTES", 1 << 16)
    monkeypatch.setattr(kernels, "_REFINE_VMEM_MEANS_BYTES", 1 << 16)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_over_cap_bank_matches_jax(small_means_cap, objective):
    """A bank over the means cap at the default geometry (stride 128): the
    scan reads the subsampled rows of the full bank and the staged refine
    replaces K2; one lobe takes its (16, 4) descent, four damped lobes are
    scored in full."""
    _staged_parity(_sig(66000)[0], 16000,
                   dict(search="coarse", objective=objective, s_clip=15.5))


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.slow) if c.startswith("60s") else c
    for c in chip_smoke.STAGED
])
def test_staged_constants_of_chip_smoke(case):
    """chip_smoke.py holds the staged single-shot encodes (10 s at tile 512
    and tile 2048; 60 s, a bank over the 9 MB cap, marked slow) to the JAX
    CPU kernel-path run's numbers; re-derive them
    (scripts/derive_staged_constants.py prints them)."""
    want = chip_smoke.STAGED[case]
    sig = bench.make_signal(want["seconds"])
    jcfg = JaxEncoderConfig(use_pallas=True, **want["kw"])
    J = jax_encode(sig, 44100, 2, config=jcfg)
    assert J[2] == want["n_ranges"]
    assert int((J[0]["idx"] < 0).sum()) == want["sentinels"]
    assert abs(_snr(sig, J, jax_decode, **want["decode"]) - want["snr_db"]) <= 5e-5
    cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
    _, _, _, lb, db = port_encode._prep_signal(sig, cfg)
    assert port_encode._plan_search(cfg, lb // cfg.range_size, db)[2] == "staged"


@pytest.mark.parametrize("case", list(chip_smoke.WIDE))
def test_wide_constants_of_chip_smoke(case):
    """chip_smoke.py holds the 10 s wide-tile encodes (tiles 8192 and
    16384) to the JAX CPU kernel-path run's numbers; re-derive them
    (scripts/derive_staged_constants.py prints them), and the plan."""
    want = chip_smoke.WIDE[case]
    sig = bench.make_signal(want["seconds"])
    jcfg = JaxEncoderConfig(use_pallas=True, **want["kw"])
    J = jax_encode(sig, 44100, 2, config=jcfg)
    assert J[2] == want["n_ranges"]
    assert int((J[0]["idx"] < 0).sum()) == want["sentinels"]
    assert abs(_snr(sig, J, jax_decode, **want["decode"]) - want["snr_db"]) <= 5e-5
    cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
    _, _, _, lb, db = port_encode._prep_signal(sig, cfg)
    assert list(port_encode._plan_search(cfg, lb // cfg.range_size, db)) == want["plan"]


def test_means_cap_raises():
    """Banks over the refine's 9 MB means cap (~53 s at 44.1 kHz) take the
    staged refine in the JAX package, and now in the port: nothing raises,
    and the plan says which refine runs."""
    cfg = EncoderConfig()
    # the bank buckets on either side of the cap: 8 MiB and 10 MiB of means
    assert port_encode._plan_search(cfg, 1 << 21, 2097152) == ("coarse", 128, "window")
    assert port_encode._plan_search(cfg, 1 << 21, 2621440) == ("coarse", 128, "staged")
    assert port_encode._plan_search(cfg, 8192, 24576) == ("exact", 128, None)
    with pytest.raises(ValueError, match="does not divide"):
        port_encode._plan_search(EncoderConfig(search="coarse"), 1024, 1000)


def test_multi_lobe_gate_matches_jax():
    """The port runs K3 then K2 exactly where the JAX package's multi-lobe
    kernel branch runs (its refine_blocks_ok gate at the bucketed bank),
    and the staged refine where that branch hands over to
    coarse_refine_search."""
    from fwav_tpu.ops.pallas_search import refine_blocks_ok as jax_gate

    from fwav_tpu_torch.models.encode import _pow2_divisor

    seen = set()
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
        refine = "window" if ok else "staged"
        assert port_encode._plan_search(cfg, mb, db) == ("coarse", stride, refine)
        seen.add(refine)
    assert seen == {"window", "staged"}


@pytest.mark.parametrize("tile,mb,db", [(1024, 20480, 65536), (1024, 20224, 65536),
                                        (512, 20480, 65536), (256, 10240, 40960),
                                        (2048, 20480, 65536), (1024, 1 << 21, 2621440)])
def test_one_lobe_gate_matches_jax(tile, mb, db):
    """One lobe takes K2 only where the JAX core's scan-kernel gate and its
    refine gate both hold (its branch at coarse_topc == 1)."""
    from fwav_tpu.ops.pallas_search import pallas_blocks_ok as jax_blocks
    from fwav_tpu.ops.pallas_search import refine_blocks_ok as jax_gate

    from fwav_tpu_torch.models.encode import _pow2_divisor

    cfg = EncoderConfig(tile_size=tile, search="coarse")
    stride = port_encode._resolve_search(cfg, cfg.range_size, db)[1]
    rblk = _pow2_divisor(mb, cfg.range_block)
    prb = 512 if rblk % 512 == 0 else _pow2_divisor(rblk, 512)
    dc = db // stride
    ok = (jax_blocks(rblk, dc, prb, _pow2_divisor(dc, cfg.domain_block))
          and jax_gate(rblk, _pow2_divisor(rblk, 512), stride, cfg.domain_step, 1,
                       cfg.objective, db))
    assert port_encode._plan_search(cfg, mb, db)[2] == ("window" if ok else "staged")
