"""A plain parser of the compact `.fwav` v2 container, frozen here.

It reads every layout the format defines (raw streams, one zlib stream
with or without idx deltas, and the entropy layout: an ext2 header, a
deflated section with the bank planes, bitmaps and rANS tables, then the
rANS streams) and returns what a decoder reads: the header, the decode
hint, the live bitmap, each live range's bank row, orientation, s and o,
and the bank as its stored float16 patterns with their power-of-two
scale. It checks the SHA-256 over the payload. NumPy only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import zlib

import numpy as np

MAGIC = b"FWAV"
VERSION = 2
_HEADER = struct.Struct("<IIBHHfIII")
_EXT = struct.Struct("<BbbBIQ")
_EXT2 = struct.Struct("<BBBBIIIIII")
_EXT2_RS = struct.Struct("<II")
_CHECKSUM_OFFSET = 34
_EXT_OFFSET = 66
FLAG_DEFLATE, FLAG_IDX_DELTA, FLAG_O_INT16, FLAG_ENTROPY, FLAG_DECODE_HINT = 1, 2, 4, 8, 16
_IDX_SPLIT_BITS = 16
PROB_BITS = 12
_RANS_L = 1 << 23


@dataclasses.dataclass
class Container:
    range_size: int
    framerate: int
    sampwidth: int
    tile_size: int
    domain_step: int
    energy_threshold: float
    n_ranges: int
    n_domains: int
    original_len: int
    hint: float | None
    live: np.ndarray       # (n_ranges,) bool
    idx: np.ndarray        # (n_live,) rows of the stored bank
    sym: np.ndarray        # (n_live,) bool
    s: np.ndarray          # (n_live,) float32
    o: np.ndarray          # (n_live,) float32
    bank_f16: np.ndarray   # (n_domains, range_size) uint16 float16 patterns
    bank_exp: int


def _inflate(buf: bytes, expected: int) -> bytes:
    d = zlib.decompressobj()
    out = d.decompress(buf, expected or 1)
    if d.unconsumed_tail or not d.eof or len(out) != expected:
        raise ValueError("corrupt or truncated payload")
    return out


def _unpack_mask(buf: bytes, m: int) -> np.ndarray:
    if m == 0:
        return np.zeros(0, bool)
    return np.unpackbits(np.frombuffer(buf, np.uint8), count=m, bitorder="little").astype(bool)


def _unpack_bits(buf: bytes, m: int, bits: int) -> np.ndarray:
    if m == 0 or bits == 0:
        return np.zeros(m, np.int64)
    if len(buf) < (m * bits + 7) // 8:
        raise ValueError("truncated idx stream")
    raw = np.unpackbits(np.frombuffer(buf, np.uint8), count=m * bits, bitorder="little")
    return raw.reshape(m, bits).astype(np.int64) @ (1 << np.arange(bits, dtype=np.int64))


def _unbyteplane(buf: bytes) -> bytes:
    a = np.frombuffer(buf, np.uint8)
    h = len(a) // 2
    out = np.empty(len(a), np.uint8)
    out[0::2] = a[:h]
    out[1::2] = a[h:]
    return out.tobytes()


def _unzigzag(z):
    return (z >> 1) ^ -(z & 1)


def _freqs(buf: bytes, alphabet: int, prob_bits: int = PROB_BITS) -> np.ndarray:
    f = np.frombuffer(buf[: 2 * alphabet], "<u2").astype(np.int64)
    if len(f) != alphabet or int(f.sum()) != 1 << prob_bits:
        raise ValueError("corrupt rANS frequency table")
    return f


def _lanes_for(m: int) -> int:
    n = 1
    while n < 8192 and n * 256 <= m:
        n <<= 1
    return n


def rans_decode(buf: bytes, m: int, f_all: np.ndarray, prob_bits: int = PROB_BITS) -> np.ndarray:
    """The lane-interleaved static rANS decoder: N u32 lane states, then
    the renormalization bytes, popped lanes descending, MSB first."""
    m_val = 1 << prob_bits
    cdf = np.zeros(len(f_all) + 1, np.int64)
    np.cumsum(f_all, out=cdf[1:])
    slot2sym = np.repeat(np.arange(len(f_all), dtype=np.int64), f_all)
    N = _lanes_for(m)
    if len(buf) < 4 * N:
        raise ValueError("truncated rANS stream")
    x = np.frombuffer(buf[: 4 * N], "<u4").astype(np.int64)
    data = np.frombuffer(buf[4 * N :], np.uint8)
    steps = -(-m // N) if m else 0
    lanes = np.arange(N)
    out = np.zeros(steps * N, dtype=np.int64)
    pos = 0
    for t in range(steps):
        active = t * N + lanes < m
        slot = x & (m_val - 1)
        s = slot2sym[slot]
        x = np.where(active, f_all[s] * (x >> prob_bits) + slot - cdf[s], x)
        out[t * N : (t + 1) * N] = np.where(active, s, 0)
        cnt = np.where(active & (x < _RANS_L), np.where(x < (_RANS_L >> 8), 2, 1), 0)
        total = int(cnt.sum())
        if total:
            if pos + total > len(data):
                raise ValueError("truncated rANS stream")
            off = np.concatenate([[0], np.cumsum(cnt[::-1])[:-1]])[::-1]
            b0 = np.zeros(N, np.int64)
            b1 = np.zeros(N, np.int64)
            t1, t2 = cnt >= 1, cnt == 2
            b0[t1] = data[pos + off[t1]]
            b1[t2] = data[pos + off[t2] + 1]
            x = np.where(t1, (x << 8) | b0, x)
            x = np.where(t2, (x << 8) | b1, x)
            pos += total
    return out[:m]


def parse(data: bytes) -> Container:
    """Parse one v2 container; raises ValueError on any malformed part."""
    if len(data) < _EXT_OFFSET + _EXT.size or data[:4] != MAGIC or data[4] != VERSION:
        raise ValueError("not a v2 FWAV container")
    hdr = _HEADER.unpack(data[5 : 5 + _HEADER.size])
    body = data[_EXT_OFFSET:]
    if hashlib.sha256(body).digest() != data[_CHECKSUM_OFFSET : _CHECKSUM_OFFSET + 32]:
        raise ValueError("checksum mismatch")
    n_ranges, n_domains, n = hdr[6], hdr[7], hdr[0]
    idx_bits, bank_exp, o_exp, flags, n_live, raw_len = _EXT.unpack(body[: _EXT.size])
    if flags & ~(FLAG_DEFLATE | FLAG_IDX_DELTA | FLAG_O_INT16 | FLAG_ENTROPY | FLAG_DECODE_HINT):
        raise ValueError(f"unknown flags 0x{flags:02x}")
    base = _EXT.size
    hint = None
    if flags & FLAG_DECODE_HINT:
        hint = body[base] / 100.0
        base += 1
    if flags & FLAG_ENTROPY:
        parts = _entropy(body, base, n, n_ranges, n_domains, n_live, idx_bits, raw_len)
        bank_b, live_b, sym_b, idx, s_u16, o_val = parts
        o = (o_val.astype(np.float64) * float(2.0 ** o_exp)).astype(np.float32)
    else:
        eff_bits = idx_bits + 1 if flags & FLAG_IDX_DELTA else idx_bits
        sizes = [n_domains * n * 2, (n_ranges + 7) // 8, (n_live + 7) // 8,
                 (n_live * eff_bits + 7) // 8, n_live * 2, n_live * 2]
        payload = body[base:]
        if flags & FLAG_DEFLATE:
            if raw_len != sum(sizes):
                raise ValueError("corrupt payload length")
            payload = _inflate(payload, sum(sizes))
        if len(payload) != sum(sizes):
            raise ValueError("truncated payload")
        segs, off = [], 0
        for sz in sizes:
            segs.append(payload[off : off + sz])
            off += sz
        bank_b, live_b, sym_b, idx_b, s_b, o_b = segs
        if flags & FLAG_DEFLATE:
            bank_b, s_b, o_b = map(_unbyteplane, (bank_b, s_b, o_b))
        idx = _unpack_bits(idx_b, n_live, eff_bits)
        if flags & FLAG_IDX_DELTA:
            idx = np.cumsum(_unzigzag(idx)).astype(np.int64)
        s_u16 = np.frombuffer(s_b, "<u2").astype(np.int64)
        o_dt = np.int16 if flags & FLAG_O_INT16 else np.float16
        o = (np.frombuffer(o_b, o_dt).astype(np.float32) * np.float32(2.0 ** o_exp))
    live = _unpack_mask(live_b, n_ranges)
    if int(live.sum()) != n_live:
        raise ValueError("corrupt live bitmap")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_domains):
        raise ValueError("corrupt idx stream")
    bank_f16 = np.frombuffer(bank_b, "<u2").reshape(n_domains, n).copy()
    s = np.frombuffer(s_u16.astype(np.uint16).tobytes(), np.float16).astype(np.float32)
    return Container(*hdr[:5], float(hdr[5]), *hdr[6:], hint, live, idx.astype(np.int64),
                     _unpack_mask(sym_b, n_live), s, o, bank_f16, int(bank_exp))


def _entropy(body, off, n, n_ranges, n_domains, n_live, idx_bits, raw_len):
    """The FLAG_ENTROPY layout: (bank bytes, live bitmap, sym bitmap, idx,
    s as float16 patterns, o as integer steps of 2^o_exp)."""
    (o_shift, _s_drop, idx_enc, so_enc, z_len, idx_len, s_hi_len, s_lo_len, o_hi_len,
     o_lo_len) = _EXT2.unpack(body[off : off + _EXT2.size])
    if o_shift > 12 or so_enc & ~3 or idx_enc > 2:
        raise ValueError("corrupt ext2 header")
    off += _EXT2.size
    idx_hi_len = idx_alpha = 0
    if idx_enc == 2:
        idx_hi_len, idx_alpha = _EXT2_RS.unpack(body[off : off + _EXT2_RS.size])
        off += _EXT2_RS.size
    s_alpha = s_lo_len if so_enc & 1 else 0
    o_alpha = o_lo_len if so_enc & 2 else 0
    lens = [z_len, idx_len, idx_hi_len, s_hi_len, 0 if so_enc & 1 else s_lo_len,
            o_hi_len, 0 if so_enc & 2 else o_lo_len]
    if len(body) - off != sum(lens):
        raise ValueError("corrupt or truncated payload")
    segs = []
    for ln in lens:
        segs.append(body[off : off + ln])
        off += ln
    zsec_b, idx_b, idx_hi_b, s_hi_b, s_lo_b, o_hi_b, o_lo_b = segs
    w_idx = 2 if n_domains <= (1 << 16) else 4
    lo_alpha = min(idx_alpha, 1 << _IDX_SPLIT_BITS)
    hi_alpha = -(-idx_alpha // (1 << _IDX_SPLIT_BITS)) if idx_alpha else 0
    if idx_enc == 2:
        idx_tab_bytes = (w_idx * idx_alpha + (2 * lo_alpha if lo_alpha > 1 else 0)
                         + (2 * hi_alpha if hi_alpha > 1 else 0))
    else:
        idx_tab_bytes = 2 * n_domains if idx_enc else 0
    sizes = [n_domains * n * 2, (n_ranges + 7) // 8, (n_live + 7) // 8, idx_tab_bytes,
             4 * s_alpha if so_enc & 1 else 512, 0 if so_enc & 1 else 512,
             4 * o_alpha if so_enc & 2 else 512, 0 if so_enc & 2 else 512]
    if raw_len != sum(sizes):
        raise ValueError("corrupt payload length")
    zsec = _inflate(zsec_b, sum(sizes))
    parts, p = [], 0
    for sz in sizes:
        parts.append(zsec[p : p + sz])
        p += sz
    bank_b, live_b, sym_b, idx_tab, s_hi_t, s_lo_t, o_hi_t, o_lo_t = parts

    def whole(tab, stream, alpha):
        vals = np.frombuffer(tab[: 2 * alpha], "<u2").astype(np.int64)
        return vals[rans_decode(stream, n_live, _freqs(tab[2 * alpha :], alpha))]

    def planes(hi_t, hi_b, lo_t, lo_b):
        return ((rans_decode(hi_b, n_live, _freqs(hi_t, 256)) << 8)
                | rans_decode(lo_b, n_live, _freqs(lo_t, 256)))

    if n_live == 0:
        idx = s_v = o_zz = np.zeros(0, np.int64)
    else:
        if idx_enc == 2:
            vals = np.frombuffer(idx_tab[: w_idx * idx_alpha],
                                 "<u2" if w_idx == 2 else "<u4").astype(np.int64)
            p0 = w_idx * idx_alpha
            ranks = np.zeros(n_live, np.int64)
            if lo_alpha > 1:
                f_lo = _freqs(idx_tab[p0 : p0 + 2 * lo_alpha], lo_alpha, _IDX_SPLIT_BITS)
                p0 += 2 * lo_alpha
                ranks = rans_decode(idx_b, n_live, f_lo, _IDX_SPLIT_BITS)
            if hi_alpha > 1:
                ranks = ranks | (rans_decode(idx_hi_b, n_live, _freqs(idx_tab[p0:], hi_alpha))
                                 << _IDX_SPLIT_BITS)
            if ranks.size and int(ranks.max()) >= idx_alpha:
                raise ValueError("corrupt idx stream")
            idx = vals[ranks]
        elif idx_enc:
            idx = rans_decode(idx_b, n_live, _freqs(idx_tab, n_domains))
        else:
            idx = _unpack_bits(idx_b, n_live, idx_bits)
        s_v = whole(s_hi_t, s_hi_b, s_alpha) if so_enc & 1 else planes(s_hi_t, s_hi_b, s_lo_t,
                                                                        s_lo_b)
        o_zz = whole(o_hi_t, o_hi_b, o_alpha) if so_enc & 2 else planes(o_hi_t, o_hi_b, o_lo_t,
                                                                         o_lo_b)
    o_val = _unzigzag(o_zz.astype(np.int64)) * (1 << o_shift)
    return _unbyteplane(bank_b), live_b, sym_b, idx, s_v, o_val
