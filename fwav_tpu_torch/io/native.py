"""ctypes binding of the native .fwav runtime (the entry points of
fwav_tpu/io/native.py that the port uses: write, read, refit, collect,
and the compact container's rans_encode, rans_decode, pack_bits and
unpack_bits).

The source is the JAX package's fwav_tpu/native/fwavio.cpp, read as a file
and never imported. It is built with g++ at first use into this package's
`_build/` directory. When no compiler or source is there, every entry
point returns None (or False) and the callers run their numpy versions,
which give the same results; this is host code and hides no device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "fwav_tpu" / "native" / "fwavio.cpp"
_LIB = _PKG / "_build" / "libfwavio.so"
_lock = threading.Lock()
_lib = None
_tried = False

_ERRORS = {
    -1: "cannot open file",
    -2: "I/O error",
    -3: "checksum seek/write failed",
    -4: "close failed",
    -5: "Not a FWAV file",
    -6: "Unsupported FWAV version",
    -7: "Truncated FWAV payload",
    -8: "Checksum mismatch — file may be corrupted",
}


def _build() -> None:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(base[:1] + ["-march=native"] + base[1:],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        subprocess.run(base, check=True, capture_output=True, timeout=120)
    os.replace(tmp, _LIB)  # atomic: a concurrent build never sees a partial file


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            cdll = ctypes.CDLL(str(_LIB))
        except (OSError, subprocess.SubprocessError):
            return None

        p, u32 = ctypes.c_void_p, ctypes.c_uint32
        cdll.fwav_write.restype = ctypes.c_int
        cdll.fwav_write.argtypes = [
            ctypes.c_char_p, u32, u32, ctypes.c_uint8, ctypes.c_uint16,
            ctypes.c_uint16, ctypes.c_float, u32, u32, u32, p, p,
        ]
        cdll.fwav_read_header.restype = ctypes.c_int
        cdll.fwav_read_header.argtypes = [ctypes.c_char_p, p, p]
        cdll.fwav_read_payload.restype = ctypes.c_int
        cdll.fwav_read_payload.argtypes = [
            ctypes.c_char_p, u32, u32, u32, ctypes.c_int, p, p,
        ]
        i64, f32 = ctypes.c_int64, ctypes.c_float
        cdll.fwav_refit.restype = ctypes.c_int
        cdll.fwav_refit.argtypes = [p, p, p, i64, i64, i64, f32, p, p, p, p]
        cdll.fwav_collect.restype = ctypes.c_int
        cdll.fwav_collect.argtypes = [p, p, p, i64, i64, i64, f32, p]
        cdll.fwav_rans_encode_pb.restype = i64
        cdll.fwav_rans_encode_pb.argtypes = [p, i64, p, i64, p, i64, i64]
        cdll.fwav_rans_decode_pb.restype = i64
        cdll.fwav_rans_decode_pb.argtypes = [p, i64, i64, p, i64, p, i64]
        cdll.fwav_pack_bits.restype = i64
        cdll.fwav_pack_bits.argtypes = [p, i64, i64, p, i64]
        cdll.fwav_unpack_bits.restype = i64
        cdll.fwav_unpack_bits.argtypes = [p, i64, i64, i64, p]
        _lib = cdll
        return _lib


def _check(code: int):
    if code != 0:
        raise ValueError(_ERRORS.get(code, f"fwavio error {code}"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def write(path, rec: np.ndarray, domains: np.ndarray, range_size, framerate,
          sampwidth, tile_size, domain_step, energy_threshold, original_len) -> bool:
    """Native single-pass writer; False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    domains = np.ascontiguousarray(domains, dtype=np.float32)
    rec = np.ascontiguousarray(rec)
    _check(
        lib.fwav_write(
            str(path).encode(), int(range_size), int(framerate), int(sampwidth),
            int(tile_size), int(domain_step), float(energy_threshold),
            len(rec), len(domains), int(original_len), _ptr(domains), _ptr(rec),
        )
    )
    return True


def refit(ranges: np.ndarray, bank: np.ndarray, idx: np.ndarray, s_clip: float):
    """Native exact affine refit (ops.affine.refit_host's rule): (s, o, err,
    sym) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    bank = np.ascontiguousarray(bank, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    m, n = ranges.shape
    s, o, err = (np.empty(m, np.float32) for _ in range(3))
    sym = np.empty(m, np.bool_)
    rc = lib.fwav_refit(
        _ptr(ranges), _ptr(bank), _ptr(idx), m, n, len(bank), float(s_clip),
        _ptr(s), _ptr(o), _ptr(err), _ptr(sym),
    )
    if rc == -10:
        raise IndexError("refit: domain index out of range for the bank")
    _check(rc)
    return s, o, err, sym


def collect(codes: np.ndarray, ranges: np.ndarray, bank: np.ndarray, s_clip: float):
    """Native 3-byte code -> MATCH record pass (sentinels + exact refit);
    None when the library is unavailable."""
    from .container import MATCH_DTYPE

    lib = _load()
    if lib is None:
        return None
    bank = np.ascontiguousarray(bank, dtype=np.float32)
    m, n = ranges.shape
    rec = np.empty(m, dtype=MATCH_DTYPE)
    rc = lib.fwav_collect(
        _ptr(codes), _ptr(ranges), _ptr(bank), m, n, len(bank), float(s_clip),
        _ptr(rec),
    )
    if rc == -10:
        raise IndexError("collect: domain index out of range for the bank")
    _check(rc)
    return rec


def read(path, verify_checksum: bool = True):
    """Native loader: load_compressed_arrays' 10-tuple, or None when the
    library is unavailable."""
    from .container import MATCH_DTYPE

    lib = _load()
    if lib is None:
        return None
    ints = np.zeros(9, dtype=np.int64)
    thr = ctypes.c_double()
    _check(lib.fwav_read_header(str(path).encode(), _ptr(ints), ctypes.byref(thr)))
    (_, range_size, framerate, sampwidth, tile_size, domain_step,
     n_ranges, n_domains, original_len) = (int(v) for v in ints)
    domains = np.empty((n_domains, range_size), dtype=np.float32)
    rec = np.empty(n_ranges, dtype=MATCH_DTYPE)
    _check(
        lib.fwav_read_payload(
            str(path).encode(), range_size, n_ranges, n_domains,
            1 if verify_checksum else 0, _ptr(domains), _ptr(rec),
        )
    )
    return (
        rec, domains, n_ranges, range_size, framerate, sampwidth,
        tile_size, domain_step, float(thr.value), original_len,
    )


def rans_encode(symbols: np.ndarray, freqs: np.ndarray, prob_bits: int = 12):
    """Native lane-interleaved rANS encode, byte-identical to io.rans's
    numpy coder. The stream bytes, or None when the library is unavailable
    or refuses the input (the numpy coder then raises the format's
    error)."""
    lib = _load()
    if lib is None:
        return None
    from .rans import _lanes_for  # capacity bound must track the spec's lanes

    sym = np.ascontiguousarray(symbols, dtype=np.int64)
    f = np.ascontiguousarray(freqs, dtype=np.int64)
    m = len(sym)
    out = np.empty(4 * _lanes_for(m) + 2 * m + 16, np.uint8)
    rc = lib.fwav_rans_encode_pb(_ptr(sym), m, _ptr(f), len(f), _ptr(out),
                                 len(out), int(prob_bits))
    if rc < 0:
        return None
    return out[:rc].tobytes()


def rans_decode(buf: bytes, m: int, freqs: np.ndarray, prob_bits: int = 12):
    """Native rANS decode: the int64 symbols, or None when the library is
    unavailable. Raises the format's ValueError on a truncated stream."""
    lib = _load()
    if lib is None:
        return None
    f = np.ascontiguousarray(freqs, dtype=np.int64)
    data = np.frombuffer(buf, np.uint8)
    out = np.empty(int(m), np.int64)
    rc = lib.fwav_rans_decode_pb(_ptr(data), len(data), int(m), _ptr(f),
                                 len(f), _ptr(out), int(prob_bits))
    if rc == -7:
        raise ValueError("Truncated rANS stream")
    if rc != 0:
        return None
    return out


def pack_bits(values: np.ndarray, bits: int):
    """Native LSB-first fixed-width bit pack, the same bytes as
    io.compact._pack_bits' numpy path; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.int64)
    m = len(v)
    out = np.empty((m * bits + 7) // 8, np.uint8)
    if lib.fwav_pack_bits(_ptr(v), m, int(bits), _ptr(out), len(out)) < 0:
        return None
    return out.tobytes()


def unpack_bits(buf: bytes, m: int, bits: int):
    """Native inverse of pack_bits; None when unavailable or on a native
    error (io.compact._unpack_bits checks the buffer length first)."""
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(buf, np.uint8)
    out = np.empty(int(m), np.int64)
    if lib.fwav_unpack_bits(_ptr(data), len(data), int(m), int(bits), _ptr(out)) != 0:
        return None
    return out
