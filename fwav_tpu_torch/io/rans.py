"""Lane-interleaved static rANS entropy coder (host-side, numpy), copied
from fwav_tpu/io/rans.py: the compact v2 container's entropy stage.

Design: classic byte-renormalized rANS (state in [L, 256L), 12-bit
quantized probabilities by default) with N interleaved lanes so the whole
coder runs as numpy vector ops over lanes — symbol i belongs to lane i % N,
the encoder walks symbols in reverse pushing bytes on one shared stack with
a fixed per-step order (lanes ascending, each lane's 0-2 bytes contiguous,
LSB first), and the decoder walks forward popping in the exact mirror
order (lanes descending, MSB first). Byte counts per lane per step are a
pure function of the decoder state (c = 0 iff x >= L, 2 iff x < L >> 8,
else 1), so read positions vectorize with a cumsum — no per-byte Python.
Throughput ~10-40 MB/s per stream on one host core at N=128 (bounded by
numpy dispatch, ~m/N vector steps); the compact writer only runs it over
~100 k-symbol streams.

prob_bits: every entry point takes the probability resolution as
a parameter (default PROB_BITS=12). Wide alphabets need it — at 12 bits an
alphabet near 4096 forces ~1 slot per symbol, so coded size degenerates to
uniform regardless of the true distribution (measured: the damped
profile's ~5k-unique idx stream packed at 13.0 bits/symbol against ~10.3
bits of empirical entropy). 16-bit tables restore ~10 slots/symbol there.
Constraint: prob_bits <= 16 keeps every quantized frequency in the u16
table format (a single-symbol alphabet at prob_bits=16 would need 65536 —
callers keep such streams at the default resolution, where 4096 fits).

Stream layout (self-contained given (m, freqs, prob_bits)): N little-endian
u32 lane states, then the renormalization bytes in decode order. The lane
count is a deterministic function of m (_lanes_for), so it is not stored.
"""

from __future__ import annotations

import numpy as np

#: Default probability resolution: frequencies sum to 2^PROB_BITS.
PROB_BITS = 12
#: Ceiling for the prob_bits parameter (u16 frequency-table entries).
MAX_PROB_BITS = 16
#: Renormalization interval lower bound: states live in [L, 256*L).
_L = 1 << 23


def _lanes_for(m: int) -> int:
    """Lane count for an m-symbol stream: enough lanes to keep the numpy
    step loop short (steps = m/N), few enough that the 4-byte-per-lane
    state flush stays negligible (N grows only while N*256 <= m, so the
    flush is always <= 1/64 of the symbol count; cap 8192 keeps hour-scale
    80M-symbol streams at ~10k vector steps)."""
    n = 1
    while n < 8192 and n * 256 <= m:
        n <<= 1
    return n


def _check_pb(prob_bits: int) -> int:
    if not 1 <= prob_bits <= MAX_PROB_BITS:
        raise ValueError(f"prob_bits out of range [1, {MAX_PROB_BITS}]: "
                         f"{prob_bits}")
    return 1 << prob_bits


def quantize_freqs(counts: np.ndarray, prob_bits: int = PROB_BITS) -> np.ndarray:
    """Quantize symbol counts to frequencies summing to exactly 2^prob_bits
    with every observed symbol kept >= 1 (largest-remainder apportionment;
    deficits/surpluses settle on the most frequent symbols, where the
    per-symbol code-length impact is smallest)."""
    m_val = _check_pb(prob_bits)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        raise ValueError("cannot build a frequency table from zero counts")
    nz = counts > 0
    if int(nz.sum()) > m_val:
        raise ValueError(
            f"alphabet has {int(nz.sum())} observed symbols; rANS at "
            f"{prob_bits} probability bits supports at most {m_val}"
        )
    scaled = counts.astype(np.float64) * (m_val / total)
    f = np.floor(scaled).astype(np.int64)
    f[nz & (f == 0)] = 1
    rem = m_val - int(f.sum())
    if rem > 0:
        # hand out the shortfall by largest fractional remainder
        frac = np.where(nz, scaled - np.floor(scaled), -1.0)
        order = np.argsort(-frac, kind="stable")[: max(rem, 0)]
        f[order] += 1
        rem = m_val - int(f.sum())
    while rem < 0:
        # took too many minimum-1 bumps: shave the largest entries
        i = int(np.argmax(f))
        take = min(f[i] - 1, -rem)
        f[i] -= take
        rem += take
    assert f.sum() == m_val and np.all(f[nz] >= 1) and np.all(f[~nz] == 0)
    return f


def encode(symbols: np.ndarray, freqs: np.ndarray,
           prob_bits: int = PROB_BITS) -> bytes:
    """Encode int symbols (all with freqs[sym] > 0) into one rANS stream.

    The native C++ coder (fwav_tpu/native/fwavio.cpp fwav_rans_encode_pb,
    bound in io/native.py) runs when available and is BIT-IDENTICAL by
    construction (same constants, lane schedule and byte order); this
    numpy implementation is the executable spec and the fallback."""
    m_val = _check_pb(prob_bits)
    sym = np.asarray(symbols, dtype=np.int64)
    f_all = np.asarray(freqs, dtype=np.int64)
    if int(f_all.sum()) != m_val:
        # Not an assert: writer-path preconditions must survive python -O,
        # or a malformed table silently yields a corrupt stream.
        raise ValueError("freqs must come from quantize_freqs "
                         "(sum == 2^prob_bits)")

    from . import native

    nat = native.rans_encode(sym, f_all, prob_bits)
    if nat is not None:
        return nat
    return _encode_np(sym, f_all, prob_bits)


def _encode_np(sym: np.ndarray, f_all: np.ndarray,
               prob_bits: int = PROB_BITS) -> bytes:
    """The numpy encoder (the executable spec the native coder must match
    byte for byte)."""
    m = len(sym)
    cdf = np.zeros(len(f_all) + 1, np.int64)
    np.cumsum(f_all, out=cdf[1:])

    N = _lanes_for(m)
    steps = -(-m // N) if m else 0
    x = np.full(N, _L, dtype=np.int64)
    lanes = np.arange(N)
    chunks = []  # byte arrays in PUSH order; final stream is the reverse
    for t in range(steps - 1, -1, -1):
        idx = t * N + lanes
        active = idx < m
        s = sym[np.where(active, idx, 0)]
        f = np.where(active, f_all[s], 1)
        x_max = ((_L >> prob_bits) << 8) * f
        em1 = active & (x >= x_max)
        b1 = (x & 0xFF).astype(np.uint8)
        x = np.where(em1, x >> 8, x)
        em2 = active & (x >= x_max)
        b2 = (x & 0xFF).astype(np.uint8)
        x = np.where(em2, x >> 8, x)
        x = np.where(active, ((x // f) << prob_bits) + (x % f) + cdf[s], x)
        n1 = em1.astype(np.int64)
        cnt = n1 + em2
        if int(cnt.sum()):
            # per-lane contiguous, LSB (b1) first, lanes ascending
            off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            buf = np.empty(int(cnt.sum()), np.uint8)
            buf[off[em1]] = b1[em1]
            buf[(off + n1)[em2]] = b2[em2]
            chunks.append(buf)
    stream = (
        np.concatenate(chunks)[::-1] if chunks else np.zeros(0, np.uint8)
    )
    states = x.astype(np.uint32).astype("<u4").tobytes()
    return states + stream.tobytes()


def decode(buf: bytes, m: int, freqs: np.ndarray,
           prob_bits: int = PROB_BITS) -> np.ndarray:
    """Decode an encode() stream back to its m symbols. Native fast path
    with the numpy spec as fallback, like encode()."""
    m_val = _check_pb(prob_bits)
    f_all = np.asarray(freqs, dtype=np.int64)
    if int(f_all.sum()) != m_val:
        raise ValueError("freqs must sum to 2^prob_bits")

    from . import native

    nat = native.rans_decode(buf, m, f_all, prob_bits)
    if nat is not None:
        return nat
    return _decode_np(buf, m, f_all, prob_bits)


def _decode_np(buf: bytes, m: int, f_all: np.ndarray,
               prob_bits: int = PROB_BITS) -> np.ndarray:
    """The numpy decoder (executable spec / fallback)."""
    m_val = 1 << prob_bits
    cdf = np.zeros(len(f_all) + 1, np.int64)
    np.cumsum(f_all, out=cdf[1:])
    slot2sym = np.repeat(
        np.arange(len(f_all), dtype=np.int64), f_all
    )  # (2^prob_bits,)

    N = _lanes_for(m)
    if len(buf) < 4 * N:
        raise ValueError("Truncated rANS stream")
    x = np.frombuffer(buf[: 4 * N], "<u4").astype(np.int64)
    data = np.frombuffer(buf[4 * N :], np.uint8)
    steps = -(-m // N) if m else 0
    lanes = np.arange(N)
    out = np.zeros(steps * N if steps else 0, dtype=np.int64)
    pos = 0
    for t in range(steps):
        idx = t * N + lanes
        active = idx < m
        slot = x & (m_val - 1)
        s = slot2sym[slot]
        f = f_all[s]
        x_new = f * (x >> prob_bits) + slot - cdf[s]
        x = np.where(active, x_new, x)
        out[t * N : (t + 1) * N] = np.where(active, s, 0)
        # renorm byte counts are a pure function of the state
        cnt = np.where(
            active & (x < _L), np.where(x < (_L >> 8), 2, 1), 0
        ).astype(np.int64)
        total = int(cnt.sum())
        if total:
            if pos + total > len(data):
                raise ValueError("Truncated rANS stream")
            # mirror of the push order: lanes DESCENDING, MSB first
            rc = cnt[::-1]
            off_desc = np.concatenate([[0], np.cumsum(rc)[:-1]])[::-1]
            b0 = np.zeros(N, np.int64)
            b1 = np.zeros(N, np.int64)
            take1 = cnt >= 1
            take2 = cnt == 2
            b0[take1] = data[pos + off_desc[take1]]
            b1[take2] = data[pos + off_desc[take2] + 1]
            x = np.where(take1, (x << 8) | b0, x)
            x = np.where(take2, (x << 8) | b1, x)
            pos += total
    return out[:m]


def serialize_freqs(freqs: np.ndarray) -> bytes:
    """Dense u16 frequency table (one entry per alphabet symbol). Callers
    embed this in a deflated header section — runs of zeros and the skewed
    low counts compress well there."""
    f = np.asarray(freqs)
    if f.max(initial=0) > 0xFFFF or f.min(initial=0) < 0:
        raise ValueError("frequency out of u16 range")
    return f.astype("<u2").tobytes()


def parse_freqs(buf: bytes, alphabet: int,
                prob_bits: int = PROB_BITS) -> np.ndarray:
    m_val = _check_pb(prob_bits)
    f = np.frombuffer(buf[: 2 * alphabet], "<u2").astype(np.int64)
    if len(f) != alphabet or int(f.sum()) != m_val:
        raise ValueError("Corrupt rANS frequency table")
    return f
