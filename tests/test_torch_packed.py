"""The port's packed batch encode (compress_audio_packed) on the CPU,
against its own single-file encode and against the JAX package's packed
encode, on the numpy-seeded signals of tests/test_packed.py at
tile_size=128.

Bar: every file's packed records, bank and header equal the port's
single-file encode exactly (the stack's device program is the single
file's with a leading file axis; no file's codes depend on its
neighbours). Against fwav_tpu.compress_audio_packed: the same sentinel
set, idx equal except at near-ties (at most 2 rows per 1,024, whose
float64 balanced gains agree to rtol 1e-5, the bar of
fwav_tpu_torch/ops/near_tie.py), the same bank, round-trip SNR within
0.01 dB."""

import numpy as np
import pytest
import torch

import fwav_tpu
import fwav_tpu_torch as port
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.ops import kernels, near_tie
from fwav_tpu_torch.parallel import make_mesh
from native_libs import ensure_native_libraries

ensure_native_libraries()

torch.set_num_threads(2)

_CACHE = {}


def _mixed_sigs():
    """tests/test_packed.py::_sigs: five tones of varied lengths (the first
    few share buckets), an empty input, an all-silent one and a float one."""
    rng = np.random.default_rng(4)
    sigs = []
    for k in range(5):
        n = 16000 + 700 * k
        t = np.arange(n) / 16000
        s = 0.4 * np.sin(2 * np.pi * (300 + 40 * k) * t)
        s += 0.01 * rng.standard_normal(n)
        s[2000:3000] = 0.0
        sigs.append(np.round(s * 16000).astype(np.float32))
    sigs.append(np.zeros(0, np.float32))
    sigs.append(np.zeros(8000, np.float32))
    sigs.append((rng.standard_normal(9000) * 0.3).astype(np.float32))
    return sigs


def _boundary_sigs():
    """tests/test_packed.py::test_packed_order_and_pack_boundary: PACK_B_MAX
    + 3 files of one bucket."""
    rng = np.random.default_rng(9)
    n = 12000
    t = np.arange(n) / 16000
    return [
        np.round((0.3 * np.sin(2 * np.pi * (200 + 17 * k) * t)
                  + 0.01 * rng.standard_normal(n)) * 16000).astype(np.float32)
        for k in range(port.PACK_B_MAX + 3)
    ]


FIXTURES = {"mixed": _mixed_sigs, "boundary": _boundary_sigs}


def _packed(name, **kw):
    """(signals, the port's packed results), once per fixture and setting."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _CACHE:
        sigs = FIXTURES[name]()
        _CACHE[key] = sigs, port.compress_audio_packed(sigs, 16000, 2, tile_size=128,
                                                       device="cpu", **kw)
    return _CACHE[key]


def _assert_same_result(got, want, msg):
    np.testing.assert_array_equal(got[0].view(np.uint8), want[0].view(np.uint8), err_msg=msg)
    np.testing.assert_array_equal(got[1], want[1], err_msg=msg)
    assert tuple(got[2:]) == tuple(want[2:]), msg


@pytest.mark.parametrize("i", range(8))
def test_packed_equals_single_file(i):
    sigs, packed = _packed("mixed")
    assert len(packed) == len(sigs)
    single = port.compress_audio_arrays(sigs[i], 16000, 2, tile_size=128, device="cpu")
    _assert_same_result(packed[i], single, f"file {i}")


@pytest.mark.parametrize("kw", [dict(objective="damped"), dict(search="coarse"),
                                dict(search="coarse", objective="damped")],
                         ids=["damped", "coarse", "coarse_damped"])
def test_packed_equals_single_file_other_branches(kw):
    """The exact damped scan, and at tile 128 the coarse branch, whose
    stride of 16 takes the staged refine (file by file inside the stack)."""
    sigs, packed = _packed("mixed", **kw)
    cfg = EncoderConfig(tile_size=128, **kw)
    _, _, _, lb, db = port_encode._prep_signal(sigs[0], cfg)
    plan = port_encode._plan_search(cfg, lb // cfg.range_size, db)
    assert plan[0] == kw.get("search", "exact") and plan[2] == (
        "staged" if "search" in kw else None)
    for i, sig in enumerate(sigs):
        single = port.compress_audio_arrays(sig, 16000, 2, tile_size=128, device="cpu", **kw)
        _assert_same_result(packed[i], single, f"file {i} {kw}")


@pytest.mark.parametrize("k", [0, port.PACK_B_MAX - 1, port.PACK_B_MAX, port.PACK_B_MAX + 2])
def test_packed_order_across_the_pack_boundary(k):
    """More files of one bucket than a stack holds: two stacks, results in
    input order."""
    sigs, packed = _packed("boundary")
    assert len(packed) == port.PACK_B_MAX + 3
    single = port.compress_audio_arrays(sigs[k], 16000, 2, tile_size=128, device="cpu")
    _assert_same_result(packed[k], single, f"file {k}")


def test_packed_stacks_by_bucket_and_dtype(monkeypatch):
    """One device program per (bucket, dtype) group and PACK_B_MAX files:
    int16-exact and float32 files never share a stack."""
    calls = []
    orig = port_encode.encode_core_packed
    monkeypatch.setattr(port_encode, "encode_core_packed",
                        lambda raw, *a: calls.append((tuple(raw.shape), raw.dtype))
                        or orig(raw, *a))
    rng = np.random.default_rng(1)
    ints = [np.round(rng.standard_normal(9000) * 3000).astype(np.float32) for _ in range(3)]
    floats = [(rng.standard_normal(9000) * 0.3).astype(np.float32) for _ in range(2)]
    sigs = [ints[0], floats[0], ints[1], floats[1], ints[2]]
    out = port.compress_audio_packed(sigs, 16000, 2, tile_size=128, device="cpu")
    assert sorted(calls, key=str) == sorted(
        [((3, 10240), torch.int16), ((2, 10240), torch.float32)], key=str)
    for i, sig in enumerate(sigs):
        _assert_same_result(out[i], port.compress_audio_arrays(
            sig, 16000, 2, tile_size=128, device="cpu"), f"file {i}")
    calls.clear()
    port.compress_audio_packed(_boundary_sigs(), 16000, 2, tile_size=128, device="cpu")
    assert [c[0][0] for c in calls] == [port.PACK_B_MAX, 3]


def test_packed_empty_and_silent_inputs():
    sigs, packed = _packed("mixed")
    for i in (5, 6):  # empty; all silent
        rec, bank, n_ranges, *_, olen = packed[i]
        assert len(rec) == 0 and bank.shape == (0, 4) and n_ranges == 0
        assert olen == len(sigs[i])
    assert port.compress_audio_packed([], 16000, 2, device="cpu") == []
    short = np.ones(50, np.float32)  # shorter than a tile: no domains
    assert port.compress_audio_packed([short], 16000, 2, device="cpu")[0][2] == 0


def test_packed_errors(monkeypatch):
    good = _mixed_sigs()[0]

    def prep(signal, cfg):
        if len(signal) == 77:
            raise ValueError("too many domains")
        return None

    monkeypatch.setattr(port_encode, "_prep_signal", prep)
    with pytest.raises(ValueError, match="signal 1: too many domains"):
        port.compress_audio_packed([good, np.ones(77, np.float32)], 16000, 2, device="cpu")
    monkeypatch.undo()
    # a mesh splits the stack's files over its cells: the same records; a
    # mesh of more cards than there are raises make_mesh's ValueError
    single = port.compress_audio_packed([good, good[:-300]], 16000, 2, device="cpu")
    meshed = port.compress_audio_packed([good, good[:-300]], 16000, 2,
                                        mesh=make_mesh(2, device="cpu"))
    for a, b in zip(single, meshed):
        assert a[0].tobytes() == b[0].tobytes() and a[2:] == b[2:]
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="requested 2 devices but only"):
            port.compress_audio_packed([good], 16000, 2, mesh=make_mesh(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.compress_audio_packed([good], 16000, 2)
    # search="topk" is ported: a stack of one gives the single encode's records
    got = port.compress_audio_packed([good], 16000, 2, search="topk", device="cpu")[0]
    one = port.compress_audio_arrays(good, 16000, 2, search="topk", device="cpu")
    assert got[0].tobytes() == one[0].tobytes() and tuple(got[2:]) == tuple(one[2:])


def test_packed_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    port.compress_audio_packed(_mixed_sigs()[:3], 16000, 2, tile_size=128, device="cpu")
    assert not any(kernels.LAUNCHES.values())


def _gains64(sig, n, bank, idx, rows):
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


@pytest.fixture(scope="module")
def jax_packed():
    return {name: fwav_tpu.compress_audio_packed(make(), 16000, 2, tile_size=128)
            for name, make in FIXTURES.items()}


@pytest.mark.parametrize("name,i", [("mixed", i) for i in range(8)]
                         + [("boundary", k) for k in (0, 15, 16, 18)])
def test_packed_matches_jax_packed(jax_packed, name, i):
    sigs, packed = _packed(name)
    J, T = jax_packed[name][i], packed[i]
    assert tuple(J[2:]) == tuple(T[2:])
    np.testing.assert_array_equal(T[1], J[1])
    rec_j, rec_t = J[0], T[0]
    np.testing.assert_array_equal(rec_t["idx"] < 0, rec_j["idx"] < 0)
    diff = np.nonzero(rec_t["idx"] != rec_j["idx"])[0]
    assert len(diff) <= near_tie.allowed_diffs(max(len(rec_j), 1))
    if len(diff):
        np.testing.assert_allclose(
            _gains64(sigs[i], J[3], J[1], rec_t["idx"][diff], diff),
            _gains64(sigs[i], J[3], J[1], rec_j["idx"][diff], diff),
            rtol=near_tie.NEAR_TIE_RTOL)
    same = rec_t["idx"] == rec_j["idx"]
    np.testing.assert_array_equal(rec_t[same].view(np.uint8), rec_j[same].view(np.uint8))
    if len(rec_j):
        snr = [fwav_tpu.compute_snr(sigs[i], dec(r[0], r[1], r[2], r[3], original_len=r[7], **kw))
               for dec, r, kw in ((jax_decode, J, {}),
                                  (port.decompress_audio, T, {"device": "cpu"}))]
        assert abs(snr[0] - snr[1]) <= 0.01, snr
