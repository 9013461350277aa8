"""The multichannel `.fwav` v3 container (copied from fwav_tpu/io/multich.py;
numpy and struct only, on the port's own compact_bytes, parse_compact_bytes
and parse_decode_hint).

Each stored channel is a complete, self-checking v2 compact blob
(io.compact.compact_bytes: pruned fp16 bank, bit-packed selection streams,
per-blob SHA-256), concatenated under a small outer header. Channels
encode independently on the device: the same length means the same shape
bucket, so all channels of a file ride one stack of
models.encode.compress_audio_packed, and decode stays per channel.

An optional mid/side transform (transform=TRANSFORM_MS, stereo only) stores
mid=(L+R)/2 and side=(L-R)/2 instead of L/R: when the channels nearly
coincide the side channel falls under the silence gate (its ranges store
as -1 sentinels) and the file shrinks. It is opt-in: on decorrelated stereo
the noise-like side channel packs worse than the raw channels. The inverse
(L=m+s, R=m-s) is exact float32 arithmetic at decode; the transform
changes what the two channels contain, never the container semantics.

Layout (little-endian):

    offset  size  field
    0       4     magic b'FWAV'
    4       1     version u8 = 3
    5       1     n_channels u8 (>= 1)
    6       1     transform u8 (0 = direct, 1 = mid/side; ms requires
                  n_channels == 2)
    7       1     reserved u8 = 0 (loaders reject nonzero, as the v2 loader
                  rejects an unknown flag)
    8       ...   per channel: u64 blob length + v2 compact blob (complete
                  container bytes including its own magic, header, SHA-256)

v1 readers fail cleanly on the version byte ('Unsupported FWAV version');
the v2 loader rejects version 3 the same way. Integrity: each channel blob
carries its own SHA-256 and deflate adler32; the outer framing is validated
structurally (the lengths must tile the file exactly).
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.trace import phase
from .compact import compact_bytes, parse_compact_bytes, parse_decode_hint
from .container import MAGIC

MULTI_VERSION = 3
TRANSFORM_DIRECT = 0
TRANSFORM_MS = 1

_OUTER = struct.Struct("<BBB")  # n_channels, transform, reserved
_LEN = struct.Struct("<Q")


def ms_forward(channels: np.ndarray) -> np.ndarray:
    """(n, 2) L/R -> (n, 2) mid/side in float32: m=(L+R)/2, s=(L-R)/2."""
    ch = np.asarray(channels, dtype=np.float32)
    if ch.ndim != 2 or ch.shape[1] != 2:
        raise ValueError("mid/side requires exactly 2 channels")
    m = 0.5 * (ch[:, 0] + ch[:, 1])
    s = 0.5 * (ch[:, 0] - ch[:, 1])
    return np.stack([m, s], axis=1)


def ms_inverse(ms: np.ndarray) -> np.ndarray:
    """(n, 2) mid/side -> (n, 2) L/R: L=m+s, R=m-s (exact float32 inverse
    of ms_forward up to one rounding of the sum)."""
    ms = np.asarray(ms, dtype=np.float32)
    if ms.ndim != 2 or ms.shape[1] != 2:
        raise ValueError("mid/side requires exactly 2 channels")
    left = ms[:, 0] + ms[:, 1]
    right = ms[:, 0] - ms[:, 1]
    return np.stack([left, right], axis=1)


def save_compressed_multi(filepath, channel_tuples, transform=TRANSFORM_DIRECT,
                          decode_damping=None):
    """Write a v3 multichannel container. channel_tuples is a list of
    per-channel 9-tuples matching compact_bytes' argument order:
    (matches, domains, range_size, framerate, sampwidth, tile_size,
    domain_step, energy_threshold, original_len). decode_damping != None
    stores the per-channel FLAG_DECODE_HINT byte (all channels encode under
    one profile, so they carry the same hint)."""
    n_ch = len(channel_tuples)
    if not 1 <= n_ch <= 255:
        raise ValueError(f"Unsupported channel count: {n_ch}")
    if transform == TRANSFORM_MS and n_ch != 2:
        raise ValueError("mid/side requires exactly 2 channels")
    if transform not in (TRANSFORM_DIRECT, TRANSFORM_MS):
        raise ValueError(f"Unknown channel transform: {transform}")
    blobs = [compact_bytes(*t, decode_damping=decode_damping)
             for t in channel_tuples]
    with phase("write"), open(filepath, "wb") as f:
        f.write(MAGIC + struct.pack("<B", MULTI_VERSION))
        f.write(_OUTER.pack(n_ch, transform, 0))
        for blob in blobs:
            f.write(_LEN.pack(len(blob)))
            f.write(blob)


def iter_channel_blobs(data: bytes):
    """Walk a v3 container's outer framing, yielding (transform, blob)
    pairs — each blob is one stored channel's raw v2 bytes, unparsed.
    Shared by load_compressed_multi and header-level reporting (`info`),
    so the framing validation can never drift between them."""
    if len(data) < 5 or data[:4] != MAGIC:
        raise ValueError("Not a FWAV file")
    if data[4] != MULTI_VERSION:
        raise ValueError(
            f"Not a multichannel FWAV container (version {data[4]})"
        )
    if len(data) < 5 + _OUTER.size:
        raise ValueError("Truncated FWAV payload")
    n_ch, transform, reserved = _OUTER.unpack(data[5 : 5 + _OUTER.size])
    if reserved != 0:
        raise ValueError(f"Unknown multichannel FWAV field: 0x{reserved:02x}")
    if transform not in (TRANSFORM_DIRECT, TRANSFORM_MS):
        raise ValueError(f"Unknown channel transform: {transform}")
    if n_ch < 1 or (transform == TRANSFORM_MS and n_ch != 2):
        raise ValueError("Corrupt multichannel FWAV header")
    off = 5 + _OUTER.size
    for _ in range(n_ch):
        if off + _LEN.size > len(data):
            raise ValueError("Truncated FWAV payload")
        (blen,) = _LEN.unpack(data[off : off + _LEN.size])
        off += _LEN.size
        if off + blen > len(data):
            raise ValueError("Truncated FWAV payload")
        yield transform, data[off : off + blen]
        off += blen
    if off != len(data):
        raise ValueError("Corrupt or truncated FWAV payload")


def multi_decode_hint(data: bytes):
    """The v3 container's decode hint: the first stored channel's
    FLAG_DECODE_HINT value (all channels carry the same one — see
    save_compressed_multi), or None. Advisory like parse_decode_hint:
    returns None on malformed framing rather than raising."""
    try:
        for _, blob in iter_channel_blobs(data):
            return parse_decode_hint(blob)
    except ValueError:
        return None
    return None


def parse_multi_bytes(data: bytes, verify_checksum: bool = True):
    """Parse a v3 container already in memory (the bytes-level half of
    load_compressed_multi, so callers that also need the raw bytes — e.g.
    the CLI's layout report — read the file once)."""
    transform = TRANSFORM_DIRECT
    channels = []
    for transform, blob in iter_channel_blobs(data):
        channels.append(
            parse_compact_bytes(blob, verify_checksum=verify_checksum)
        )
    return channels, transform


def load_compressed_multi(filepath, verify_checksum: bool = True):
    """Load a v3 container: returns (channels, transform) where channels is
    a list of per-channel 10-tuples in load_compressed_arrays' shape. The
    stored channels come back as stored — callers undo a TRANSFORM_MS with
    ms_inverse AFTER decoding each channel."""
    with open(filepath, "rb") as f:
        data = f.read()
    return parse_multi_bytes(data, verify_checksum=verify_checksum)
