"""The `.fwav` v1 container (copied from fwav_tpu/io/container.py; both
packages write the same bytes and read each other's files).

Layout (little-endian):

    offset  size  field
    0       4     magic b'FWAV'
    4       1     version u8 (= 1)
    5       4     range_size u32
    9       4     framerate u32
    13      1     sampwidth u8
    14      2     tile_size u16
    16      2     domain_step u16
    18      4     energy_threshold f32
    22      4     n_ranges u32
    26      4     n_domains u32
    30      4     original_len u32
    34      32    SHA-256 of payload (domains then matches, in write order)
    66      n_domains*range_size*4   domain tiles (float32, row-major)
    ...     n_ranges*17              match records '<iffBf' =
                                     (domain_idx i32 [-1 = silent sentinel],
                                      s f32, o f32, sym u8, err f32)

The compact v2 layout is io/compact.py; load_compressed_arrays reads both.
save_compressed_streaming writes the v1 bytes from a bank given in blocks.
The multichannel v3 layout is io/multich.py. read_version, read_header and
read_matches read only what the CLI's `info` reports.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

from ..config import FWAV_VERSION

MAGIC = b"FWAV"
_HEADER = struct.Struct("<IIBHHfIII")  # after magic+version
_CHECKSUM_OFFSET = 34
_PAYLOAD_OFFSET = 66
_CHUNK = 1 << 22  # 4 MiB streaming granularity

#: Packed match record: 17 bytes, matching struct '<iffBf'.
MATCH_DTYPE = np.dtype(
    [("idx", "<i4"), ("s", "<f4"), ("o", "<f4"), ("sym", "u1"), ("err", "<f4")]
)
assert MATCH_DTYPE.itemsize == 17


def matches_to_struct(matches) -> np.ndarray:
    """Normalize matches to the packed record array. Accepts a list of
    (idx, s, o, sym, err) tuples, a dict of arrays, or a record array."""
    if isinstance(matches, np.ndarray) and matches.dtype == MATCH_DTYPE:
        return matches
    if isinstance(matches, dict):
        n = len(matches["idx"])
        rec = np.empty(n, dtype=MATCH_DTYPE)
        rec["idx"] = np.asarray(matches["idx"], dtype=np.int32)
        rec["s"] = np.asarray(matches["s"], dtype=np.float32)
        rec["o"] = np.asarray(matches["o"], dtype=np.float32)
        rec["sym"] = np.asarray(matches["sym"], dtype=np.uint8)
        rec["err"] = np.asarray(matches["err"], dtype=np.float32)
        return rec
    rec = np.empty(len(matches), dtype=MATCH_DTYPE)
    for i, m in enumerate(matches):
        rec[i] = (int(m[0]), float(m[1]), float(m[2]), int(m[3]), float(m[4]))
    return rec


def struct_to_matches(rec: np.ndarray) -> list:
    """Record array -> list of Python tuples."""
    return list(
        zip(
            rec["idx"].tolist(),
            rec["s"].astype(np.float64).tolist(),
            rec["o"].astype(np.float64).tolist(),
            rec["sym"].tolist(),
            rec["err"].astype(np.float64).tolist(),
        )
    )


def pack_header(
    range_size, framerate, sampwidth, tile_size, domain_step, energy_threshold,
    n_ranges, n_domains, original_len,
) -> bytes:
    return (
        MAGIC
        + struct.pack("<B", FWAV_VERSION)
        + _HEADER.pack(
            int(range_size), int(framerate), int(sampwidth), int(tile_size),
            int(domain_step), float(energy_threshold), int(n_ranges),
            int(n_domains), int(original_len),
        )
    )


def save_compressed(
    filepath,
    matches,
    domains_array,
    range_size,
    framerate,
    sampwidth,
    tile_size,
    domain_step,
    energy_threshold,
    original_len,
) -> None:
    """Single-pass write with seek-back SHA-256. Uses the native writer
    (io.native) when its library builds; otherwise save_compressed_streaming
    writes the same bytes with the bank as one block."""
    rec = matches_to_struct(matches)
    domains = np.ascontiguousarray(np.asarray(domains_array, dtype=np.float32))

    from . import native

    if native.write(
        filepath, rec, domains, range_size, framerate, sampwidth, tile_size,
        domain_step, energy_threshold, original_len,
    ):
        return
    save_compressed_streaming(
        filepath, rec, [domains], len(domains), range_size, framerate, sampwidth,
        tile_size, domain_step, energy_threshold, original_len,
    )


def _write_hashed(f, sha, flat: np.ndarray) -> None:
    """Write a uint8 array and hash it, in _CHUNK pieces."""
    for off in range(0, flat.nbytes, _CHUNK):
        chunk = flat[off : off + _CHUNK].tobytes()
        f.write(chunk)
        sha.update(chunk)


def save_compressed_streaming(
    filepath,
    matches,
    domain_blocks,
    n_domains,
    range_size,
    framerate,
    sampwidth,
    tile_size,
    domain_step,
    energy_threshold,
    original_len,
) -> None:
    """save_compressed with the bank given as an iterator of (rows,
    range_size) float32 blocks (models/stream.py domain_block_iter), so
    that the bank of a long file never materializes. The same bytes as
    save_compressed. The file is written beside the target and renamed
    into place on success, so a failing iterator never leaves a truncated
    container at the target path."""
    rec = matches_to_struct(matches)
    n_ranges = len(rec)
    tmp_path = f"{filepath}.tmp"
    sha = hashlib.sha256()
    written = 0
    try:
        with open(tmp_path, "wb") as f:
            f.write(
                pack_header(
                    range_size, framerate, sampwidth, tile_size, domain_step,
                    energy_threshold, n_ranges, n_domains, original_len,
                )
            )
            f.write(b"\0" * 32)  # checksum placeholder
            for block in domain_blocks:
                block = np.ascontiguousarray(block, dtype=np.float32)
                _write_hashed(f, sha, block.reshape(-1).view(np.uint8))
                written += len(block)
            if written != n_domains:
                raise ValueError(
                    f"domain block iterator yielded {written} rows, expected {n_domains}"
                )
            _write_hashed(f, sha, rec.view(np.uint8).reshape(-1))
            f.seek(_CHECKSUM_OFFSET)
            f.write(sha.digest())
        os.replace(tmp_path, filepath)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise


def read_version(filepath) -> int:
    """Magic check and the version byte (1 = v1, 2 = compact, 3 =
    multichannel)."""
    with open(filepath, "rb") as f:
        head = f.read(5)
    if len(head) < 5 or head[:4] != MAGIC:
        raise ValueError("Not a FWAV file")
    return head[4]


def read_header(filepath):
    """Parse only the fixed 66-byte header (shared by v1 and v2). Returns
    the 9-tuple (range_size, framerate, sampwidth, tile_size, domain_step,
    energy_threshold, n_ranges, n_domains, original_len)."""
    with open(filepath, "rb") as f:
        head = f.read(5 + _HEADER.size)
    if len(head) < 5 or head[:4] != MAGIC:
        raise ValueError("Not a FWAV file")
    if head[4] not in (FWAV_VERSION, 2):
        raise ValueError(f"Unsupported FWAV version: {head[4]}")
    if len(head) < 5 + _HEADER.size:
        raise ValueError("Truncated FWAV payload")
    return _HEADER.unpack(head[5:])


def read_matches(filepath) -> np.ndarray:
    """Read only the match record table, seeking past a v1 bank. A v2 bank
    is bounded by the range count, so there the full loader is no dearer."""
    version = read_version(filepath)
    if version == 3:
        raise ValueError(
            "Multichannel FWAV container — load via "
            "io.multich.load_compressed_multi (CLI decompress handles it)"
        )
    if version == 2:
        from .compact import load_compressed_compact

        return load_compressed_compact(filepath, verify_checksum=False)[0]
    (range_size, _fr, _sw, _tile, _step, _thr, n_ranges, n_domains, _olen) = (
        read_header(filepath)
    )
    with open(filepath, "rb") as f:
        f.seek(_PAYLOAD_OFFSET + n_domains * range_size * 4)
        buf = f.read(n_ranges * MATCH_DTYPE.itemsize)
    if len(buf) != n_ranges * MATCH_DTYPE.itemsize:
        raise ValueError("Truncated FWAV payload")
    return np.frombuffer(buf, dtype=MATCH_DTYPE)


def load_compressed_arrays(filepath, verify_checksum: bool = True):
    """Load a v1 or compact v2 .fwav: (records, domains, n_ranges,
    range_size, framerate, sampwidth, tile_size, domain_step,
    energy_threshold, original_len). v1 uses the native parser when its
    library builds; v2 goes to io.compact.load_compressed_compact."""
    with open(filepath, "rb") as f:
        head = f.read(5)
    if len(head) < 5 or head[:4] != MAGIC:
        raise ValueError("Not a FWAV file")
    if head[4] == 2:
        from .compact import load_compressed_compact

        return load_compressed_compact(filepath, verify_checksum=verify_checksum)
    if head[4] == 3:
        raise ValueError(
            "Multichannel FWAV container (v3): load it with "
            "io.multich.load_compressed_multi"
        )

    from . import native

    out = native.read(filepath, verify_checksum=verify_checksum)
    if out is not None:
        return out

    with open(filepath, "rb") as f:
        f.read(4)
        version = struct.unpack("<B", f.read(1))[0]
        if version != FWAV_VERSION:
            raise ValueError(f"Unsupported FWAV version: {version}")
        hdr = f.read(_HEADER.size)
        if len(hdr) != _HEADER.size:
            raise ValueError("Truncated FWAV payload")
        (
            range_size, framerate, sampwidth, tile_size, domain_step,
            energy_threshold, n_ranges, n_domains, original_len,
        ) = _HEADER.unpack(hdr)
        stored_checksum = f.read(32)
        dom_buf = f.read(n_domains * range_size * 4)
        match_buf = f.read(n_ranges * MATCH_DTYPE.itemsize)
        if (len(dom_buf) != n_domains * range_size * 4
                or len(match_buf) != n_ranges * MATCH_DTYPE.itemsize):
            raise ValueError("Truncated FWAV payload")
        if verify_checksum:
            sha = hashlib.sha256()
            sha.update(dom_buf)
            sha.update(match_buf)
            if sha.digest() != stored_checksum:
                raise ValueError("Checksum mismatch — file may be corrupted")

    domains = np.frombuffer(dom_buf, dtype=np.float32).reshape(n_domains, range_size)
    rec = np.frombuffer(match_buf, dtype=MATCH_DTYPE)
    return (
        rec, domains, n_ranges, range_size, framerate, sampwidth, tile_size,
        domain_step, energy_threshold, original_len,
    )


def load_compressed(filepath, verify_checksum: bool = True):
    """Reference-shaped loader: load_compressed_arrays with the matches as
    a list of tuples."""
    rec, *rest = load_compressed_arrays(filepath, verify_checksum=verify_checksum)
    return (struct_to_matches(rec), *rest)
