"""The port's multichannel v3 container (fwav_tpu_torch/io/multich.py)
against the JAX package's on the same records: the bytes are equal, each
package reads the other's file to equal arrays, the mid/side transform and
the decode hint agree, and malformed framing fails the same way. Bar: byte
and array equality."""

import numpy as np
import pytest
from test_torch_compact import _hdr, _records

import fwav_tpu_torch as port
from fwav_tpu.io import multich as jax_multich
from fwav_tpu_torch.io import multich
from native_libs import ensure_native_libraries

ensure_native_libraries()


def _channels(kinds):
    out = []
    for seed, kind in enumerate(kinds):
        rec, bank, N = _records(kind, seed)
        out.append((rec, bank, *_hdr(rec, N)))
    return out


CASES = {
    "mono": (["random"], multich.TRANSFORM_DIRECT, None),
    "stereo": (["random", "drift"], multich.TRANSFORM_DIRECT, None),
    "ms_hint": (["random", "silent"], multich.TRANSFORM_MS, 0.25),
    "five": (["random", "drift", "silent", "n8", "wide"], multich.TRANSFORM_DIRECT, 0.25),
}


@pytest.mark.parametrize("case", list(CASES))
def test_v3_bytes_equal_and_cross_load(case, tmp_path):
    kinds, transform, hint = CASES[case]
    chans = _channels(kinds)
    pj, pt = tmp_path / "jax.fwav", tmp_path / "port.fwav"
    jax_multich.save_compressed_multi(pj, chans, transform=transform, decode_damping=hint)
    port.save_compressed_multi(pt, chans, transform=transform, decode_damping=hint)
    assert pj.read_bytes() == pt.read_bytes()
    assert multich.multi_decode_hint(pt.read_bytes()) == hint
    assert jax_multich.multi_decode_hint(pt.read_bytes()) == hint
    for a, b in ((jax_multich.load_compressed_multi(pt), port.load_compressed_multi(pj)),
                 (jax_multich.parse_multi_bytes(pj.read_bytes()),
                  multich.parse_multi_bytes(pt.read_bytes(), verify_checksum=False))):
        assert a[1] == b[1] == transform and len(a[0]) == len(b[0]) == len(kinds)
        for ca, cb in zip(a[0], b[0]):
            assert len(ca) == len(cb) == 10
            for x, y in zip(ca, cb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    blobs = list(multich.iter_channel_blobs(pt.read_bytes()))
    assert [t for t, _ in blobs] == [transform] * len(kinds)
    assert [b for _, b in blobs] == [b for _, b in jax_multich.iter_channel_blobs(pj.read_bytes())]


def test_mid_side_round_trip_and_matches_jax():
    rng = np.random.default_rng(0)
    lr = (rng.standard_normal((5000, 2)) * 8000).astype(np.float32)
    ms = multich.ms_forward(lr)
    np.testing.assert_array_equal(ms, jax_multich.ms_forward(lr))
    back = multich.ms_inverse(ms)
    np.testing.assert_array_equal(back, jax_multich.ms_inverse(ms))
    np.testing.assert_allclose(back, lr, rtol=0, atol=4e-3)  # ulps of the 16-bit scale
    # 16-bit content whose sum and difference are even: the inverse is exact
    m, d = rng.integers(-8000, 8000, (2, 5000)).astype(np.float32)
    even = np.stack([m + d, m - d], axis=1)
    np.testing.assert_array_equal(multich.ms_inverse(multich.ms_forward(even)), even)
    for bad in (lr[:, :1], np.zeros((4, 3), np.float32), lr[:, 0]):
        with pytest.raises(ValueError, match="exactly 2 channels"):
            multich.ms_forward(bad)
        with pytest.raises(ValueError, match="exactly 2 channels"):
            multich.ms_inverse(bad)


def test_v3_constants_match_jax():
    for name in ("MULTI_VERSION", "TRANSFORM_DIRECT", "TRANSFORM_MS"):
        assert getattr(multich, name) == getattr(jax_multich, name)
    assert multich.MULTI_VERSION == 3


@pytest.mark.parametrize("what,match", [
    ("no_channels", "channel count"), ("ms_three", "exactly 2"), ("transform", "transform"),
])
def test_save_refuses(what, match, tmp_path):
    chans = _channels(["random", "drift", "silent"])
    args = {"no_channels": ([], {}), "ms_three": (chans, {"transform": multich.TRANSFORM_MS}),
            "transform": (chans[:2], {"transform": 7})}[what]
    for save in (port.save_compressed_multi, jax_multich.save_compressed_multi):
        with pytest.raises(ValueError, match=match):
            save(tmp_path / "x.fwav", args[0], **args[1])


@pytest.mark.parametrize("damage,match", [
    ("magic", "Not a FWAV"), ("version", "Not a multichannel"),
    ("reserved", "Unknown multichannel"),
    ("transform", "Unknown channel transform"), ("ms_mono", "Corrupt multichannel"),
    ("truncated", "Truncated"), ("trailing", "Corrupt or truncated"), ("header", "Truncated"),
])
def test_malformed_v3_fails_as_in_jax(damage, match, tmp_path):
    p = tmp_path / "m.fwav"
    port.save_compressed_multi(p, _channels(["random", "silent"]))
    data = bytearray(p.read_bytes())
    if damage == "magic":
        data[0] = 0
    elif damage == "version":
        data[4] = 2
    elif damage == "reserved":
        data[7] = 1
    elif damage == "transform":
        data[6] = 9
    elif damage == "ms_mono":
        data[5], data[6] = 1, 1
    elif damage == "truncated":
        data = data[:-10]
    elif damage == "trailing":
        data += b"\\0"
    elif damage == "header":
        data = data[:6]
    for parse in (multich.parse_multi_bytes, jax_multich.parse_multi_bytes):
        with pytest.raises(ValueError, match=match):
            parse(bytes(data))
    # the hint is advisory: malformed framing gives None, never an error
    if damage not in ("truncated", "trailing"):
        assert multich.multi_decode_hint(bytes(data)) is None


def test_v3_checksum_is_per_channel(tmp_path):
    p = tmp_path / "m.fwav"
    port.save_compressed_multi(p, _channels(["random", "drift"]))
    data = bytearray(p.read_bytes())
    data[-40] ^= 0xFF  # inside the last channel's blob
    with pytest.raises(ValueError):
        multich.parse_multi_bytes(bytes(data))
