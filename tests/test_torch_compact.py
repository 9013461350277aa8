"""The port's compact v2 container against the JAX package's: the same
records give the same bytes (with and without the decode hint, on every
layout the keep-smallest writer picks), each package loads the other's
files to equal arrays, and the port's rANS coder and bit packing, native
and numpy, give the JAX package's bytes. Bar: byte and array equality."""

import numpy as np
import pytest

import fwav_tpu_torch as port
from fwav_tpu.io import compact as jax_compact
from fwav_tpu.io import rans as jax_rans
from fwav_tpu.io.container import load_compressed_arrays as jax_load
from fwav_tpu.io.multich import save_compressed_multi
from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
from fwav_tpu.models.encode import prune_bank as jax_prune
from fwav_tpu_torch.io import compact, native, rans
from native_libs import ensure_native_libraries

ensure_native_libraries()


def _records(kind, seed=0):
    """(records, bank, range_size) of one kind of table."""
    rng = np.random.default_rng(seed)
    if kind in ("speechlike", "speechlike_damped"):
        sr = 16000
        t = np.arange(sr) / sr
        sig = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.2 * np.sin(2 * np.pi * 800 * t)
        sig[4800:6400] = 0.0
        sig = (sig * 16000).astype(np.float32)
        objective = "damped" if kind.endswith("damped") else "balanced"
        rec, bank, *_ = jax_encode(sig, sr, 2, objective=objective)
        rec, bank = jax_prune(rec, bank)
        return rec, bank, 4
    n, n_dom, N = {"random": (3000, 900, 4), "wide": (90000, 50000, 4),
                   "drift": (4096, 5000, 4), "silent": (500, 1, 4),
                   "n8": (700, 300, 8)}[kind]
    rec = np.zeros(n, port.MATCH_DTYPE)
    live = rng.random(n) < (0.0 if kind == "silent" else 0.9)
    if kind == "drift":  # neighbouring ranges select neighbouring domains
        idx = (np.arange(n) + np.arange(n) % 3) % n_dom
    elif kind == "wide":  # a skewed alphabet over 2^12 rows: rank-split idx
        idx = rng.zipf(1.25, n) % 20000
    else:
        idx = rng.integers(0, n_dom, n)
    rec["idx"] = np.where(live, idx, -1)
    rec["s"] = np.where(live, rng.uniform(-16, 16, n), 1.0)
    rec["o"] = np.where(live, rng.normal(0, 3e3, n), 0.0)
    rec["sym"] = np.where(live, rng.integers(0, 2, n), 0)
    rec["err"] = np.where(live, np.abs(rng.normal(0, 50, n)), 0.0)
    bank = rng.normal(0, 500.0, (n_dom, N)).astype(np.float32)
    return rec, bank, N


KINDS = ["speechlike", "speechlike_damped", "random", "wide", "drift", "silent", "n8"]


def _hdr(rec, N):
    return (N, 44100, 2, 1024, 1, 1e-4, len(rec) * N)


@pytest.mark.parametrize("hint", [None, 0.25])
@pytest.mark.parametrize("kind", KINDS)
def test_v2_bytes_equal_and_cross_load(kind, hint, tmp_path):
    rec, bank, N = _records(kind)
    pj, pt = tmp_path / "jax.fwav", tmp_path / "port.fwav"
    jax_compact.save_compressed_compact(pj, rec, bank, *_hdr(rec, N), decode_damping=hint)
    port.save_compressed_compact(pt, rec, bank, *_hdr(rec, N), decode_damping=hint)
    assert pj.read_bytes() == pt.read_bytes()
    assert port.parse_decode_hint(pt.read_bytes()[:128]) == hint
    assert jax_compact.parse_decode_hint(pt.read_bytes()[:128]) == hint
    # each loads the other's file, through the version-dispatching loaders
    for a, b in ((jax_load(str(pt)), port.load_compressed_arrays(pj)),
                 (jax_compact.load_compressed_compact(pt), port.load_compressed_compact(pj))):
        assert len(a) == len(b) == 10
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_v2_layouts_are_exercised():
    """The kinds above cover the writer's layouts: entropy with dense and
    rank-split idx, and the legacy deflate layout."""
    layouts = set()
    for kind in KINDS:
        rec, bank, N = _records(kind)
        blob = compact.compact_bytes(rec, bank, *_hdr(rec, N))
        d = jax_compact.describe_layout(blob)
        layouts.add((d["layout"], d.get("idx_coding")))
    assert ("entropy", "rank_split") in layouts and ("entropy", "rans") in layouts
    assert any(lay == "deflate" for lay, _ in layouts)


def test_v2_hint_and_corruption_errors(tmp_path):
    rec, bank, N = _records("random")
    p = tmp_path / "f.fwav"
    port.save_compressed_compact(p, rec, bank, *_hdr(rec, N), decode_damping=0.25)
    data = bytearray(p.read_bytes())
    data[-1] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Checksum"):
        port.load_compressed_arrays(p)
    for bad in (float("nan"), 3.0):
        with pytest.raises(ValueError, match="decode_damping"):
            port.save_compressed_compact(p, rec, bank, *_hdr(rec, N), decode_damping=bad)
    v1 = tmp_path / "v1.fwav"
    port.save_compressed(v1, rec, bank, *_hdr(rec, N))
    assert port.parse_decode_hint(v1.read_bytes()[:128]) is None


def test_v3_raises(tmp_path):
    rec, bank, N = _records("random")
    p = tmp_path / "multi.fwav"
    save_compressed_multi(p, [(rec, bank, *_hdr(rec, N))] * 2)
    with pytest.raises(ValueError, match="load_compressed_multi"):
        port.load_compressed_arrays(p)
    with pytest.raises(ValueError, match="Multichannel"):  # the JAX package's words
        jax_load(str(p))


@pytest.mark.parametrize("prob_bits", [12, 16])
def test_rans_matches_jax_native_and_numpy(prob_bits):
    rng = np.random.default_rng(prob_bits)
    alpha = 300 if prob_bits == 12 else 20000
    sym = np.minimum(rng.zipf(1.4, 50000), alpha) - 1
    f = rans.quantize_freqs(np.bincount(sym, minlength=alpha), prob_bits)
    np.testing.assert_array_equal(f, jax_rans.quantize_freqs(
        np.bincount(sym, minlength=alpha), prob_bits))
    nat = native.rans_encode(sym, f, prob_bits)
    assert nat is not None  # the native library builds here
    assert nat == rans._encode_np(sym, f, prob_bits) == jax_rans.encode(sym, f, prob_bits)
    np.testing.assert_array_equal(rans.decode(nat, len(sym), f, prob_bits), sym)
    np.testing.assert_array_equal(rans._decode_np(nat, len(sym), f, prob_bits), sym)
    with pytest.raises(ValueError, match="Truncated"):
        rans.decode(nat[:40], len(sym), f, prob_bits)


@pytest.mark.parametrize("bits", [1, 7, 13, 24])
def test_bit_packing_native_matches_numpy(bits, monkeypatch):
    rng = np.random.default_rng(bits)
    v = rng.integers(0, 1 << bits, 10001)
    nat = compact._pack_bits(v, bits)
    np.testing.assert_array_equal(compact._unpack_bits(nat, len(v), bits), v)
    monkeypatch.setattr(native, "pack_bits", lambda *a: None)
    monkeypatch.setattr(native, "unpack_bits", lambda *a: None)
    assert compact._pack_bits(v, bits) == nat
    np.testing.assert_array_equal(compact._unpack_bits(nat, len(v), bits), v)
