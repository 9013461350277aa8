"""The compact `.fwav` v2 container (copied from fwav_tpu/io/compact.py;
both packages write the same bytes and read each other's files).

Version 1 (io/container.py) stores the bank as float32 and 17 bytes per
range. Version 2 is the rate-focused encoding of the SAME decode inputs:

- the bank is pruned to referenced rows (bounded by the range count) and
  stored float16 with an exact power-of-2 scale (scale_exp): scaling only
  changes fp exponents, so the only loss is the fp16 rounding itself;
- matches split into bit-exact selection streams (a live bitmap, a sym
  bitmap, domain indices bit-packed at the minimal width for the pruned
  bank) and quantized parameter streams: s as float16 (a dimensionless
  ratio clipped to +/-16, never scaled), o as int16 fixed point under its
  own power-of-2 exponent (see the layout notes below);
- `err` is not stored: no decoder consumes it (decode reads only
  idx/s/o/sym); loaders return err=0.

Selection (idx/sym/live) is preserved bit-exactly; s/bank quantize to
float16 and o to int16 fixed point, with the entropy layout additionally
applying DISTORTION-BOUNDED extra quantization (see FLAG_ENTROPY /
_QUANT_GAMMA).

Layout (little-endian; first 66 bytes shaped exactly like v1 with
version=2, so v1-only readers fail cleanly on the version byte):

    offset  size  field
    0       4     magic b'FWAV'
    4       1     version u8 = 2
    5       29    range_size u32, framerate u32, sampwidth u8, tile_size
                  u16, domain_step u16, energy_threshold f32, n_ranges u32,
                  n_domains u32 (stored bank rows), original_len u32
    34      32    SHA-256 over EVERYTHING after offset 66
    66      16    ext header: idx_bits u8, bank_scale_exp i8, o_scale_exp
                  i8, flags u8 (FLAG_*), n_live u32, raw_payload_len u64
    82      0|1   decode-hint byte (only when flags & FLAG_DECODE_HINT):
                  preferred decoder s_damping in 1/100 units
    82+     ...   payload — if flags & FLAG_DEFLATE, one zlib stream
                  inflating to raw_payload_len bytes; else the raw streams:

    raw stream order (sizes derivable from the headers alone):
            bank          n_domains*range_size float16
                          (value * 2^-bank_scale_exp)
            live bitmap   ceil(n_ranges/8) bytes (bit i: match i live)
            sym bitmap    ceil(n_live/8) bytes (per live match)
            idx stream    ceil(n_live*W/8) bytes, LSB-first; W = idx_bits,
                          or idx_bits+1 zigzag first-differences when
                          flags & FLAG_IDX_DELTA
            s             n_live float16
            o             n_live int16 fixed point (FLAG_O_INT16 set):
                          stored = round(value * 2^-o_scale_exp),
                          saturated to [-32767, 32767]; float16
                          (* 2^-o_scale_exp) when the flag is clear

With FLAG_ENTROPY (the round-4 layout; the writer picks whichever encoding
is smallest), a 28-byte ext2 header follows the ext header —

    ext2:   o_shift u8 (extra pow2 offset-quantization shift),
            s_drop u8 (fp16 mantissa bits rounded off s, informational),
            idx_enc u8 (1 = symbol rANS, 0 = plain packed at idx_bits),
            so_enc u8 (bit0/bit1: s/o whole-value coded — see _EXT2),
            z_len u32, idx_len u32, s_hi_len u32,
            s_lo_len u32, o_hi_len u32, o_lo_len u32

— and the payload is: one zlib section of z_len bytes (inflating to
raw_payload_len = bank planes + live bitmap + sym bitmap + the rANS
frequency tables: dense u16 x n_domains for idx when idx_enc=1, then per
parameter stream either 256-entry u16 tables for its hi/lo byte planes
or, when its so_enc bit is set, the sorted unique u16 values plus their
frequency table), followed by the streams at their ext2 lengths. s is
stored as quantized fp16 bit patterns, o as zigzag(round(o16 /
2^o_shift)); each is either split into lo/hi byte planes — two
lane-interleaved rANS streams (io.rans) — or coded as ONE whole-value
rANS stream over its observed alphabet, whichever is smaller per file
(byte planes discard cross-byte correlation; whole-value coding needs
the alphabet under the coder's 2^PROB_BITS cap). idx is one symbol-level
rANS stream over the bank alphabet (or the legacy bit packing when the
bank exceeds the table budget). o_shift and the s
mantissa drop are chosen per file so each adds less than _QUANT_GAMMA of
the encoder's own residual energy (rec['err']) to any decoder's output —
the entropy layout trusts err as the residual scale, which holds for
every file this encoder writes (err=0 tables get zero extra
quantization).

All bitmaps/bit-streams pack LSB-first (numpy bitorder='little'). The bank
and o streams carry independent power-of-2 scale exponents (exact: only fp
exponents change). The bank stays float16 with its peak landed in
(8192, 16384] — its role is multiplicative, so relative precision is what
matters. o is int16 FIXED point with its peak landed in (16384, 32768],
because the default decode's output IS o per range (models/decode.py
closed form) and uniform absolute error is what minimizes output
distortion: worst-case error is peak * 2^-15 — 0.5 LSB on full-scale
16-bit PCM content, ~16x better than float16's near-peak ulp at the same
2 bytes/value — with up to 1 ulp at the single saturated peak sample when
the scaled peak rounds to 32768. Non-finite offsets are rejected at write
time (ValueError) rather than silently quantized. s stays float16: it is
a dimensionless ratio clipped to +/-16 and only relative precision
matters. Under FLAG_DEFLATE the two-byte streams are byte-planed (see
FLAG_DEFLATE comment) and the writer keeps whichever of
{raw, deflate, deflate+idx-delta} is smallest, so the entropy stage can
never lose bytes and is exactly lossless over the quantized streams.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

from .container import MAGIC, MATCH_DTYPE, _HEADER, matches_to_struct

COMPACT_VERSION = 2
_EXT = struct.Struct("<BbbBIQ")
_CHECKSUM_OFFSET = 34
_EXT_OFFSET = 66

#: ext-header flags (u8). DEFLATE: the payload after the ext header is one
#: zlib stream of the raw concatenated streams, with every two-byte stream
#: (bank/s/o) byte-planed (all low bytes, then all high bytes — the
#: near-constant high bytes deflate well). IDX_DELTA: the idx stream holds
#: zigzag(first-difference) packed at idx_bits+1 instead of raw indices at
#: idx_bits (neighbouring ranges select nearby domains, so deltas
#: concentrate near zero and deflate again wins). O_INT16: the o stream is
#: int16 fixed point instead of the original float16 encoding — always set
#: by this writer; the loader honors both so early-v2 files keep decoding
#: correctly. The writer measures the variants and keeps the smallest;
#: flags tell the loader exactly which transforms to undo.
FLAG_DEFLATE = 1
FLAG_IDX_DELTA = 2
FLAG_O_INT16 = 4
#: ENTROPY: the round-4 rate layout — an ext2 header follows the ext
#: header, streams are rANS entropy-coded per byte plane (io.rans) with
#: per-file frequency tables, and o/s carry DISTORTION-BOUNDED quantization
#: (o_shift dropped offset LSBs, s_drop dropped fp16 mantissa bits) chosen
#: by the writer so the added noise stays under _QUANT_GAMMA of the
#: encoder's own measured residual — see _pick_o_shift/_pick_s_drop.
FLAG_ENTROPY = 8
#: DECODE_HINT: ONE extra byte sits between the ext header and the
#: ext2/payload — the writer's preferred decoder s_damping in 1/100 units
#: (u8; 25 == the damped profile's 0.25). Round 4 measured the trap this
#: kills: a damped-profile file decoded at the default damping=0 lands
#: BELOW the default profile (~1.1 dB vs 6.6 dB on the bench fixture)
#: while the hinted decode reaches ~40 dB — the 34 dB win must not hide
#: behind a flag the user has to know about. The hint is advisory: any
#: explicit --damping overrides it, and v1 (reference-frozen) never
#: carries one.
FLAG_DECODE_HINT = 16


#: Values per bit-packing chunk. Must be a multiple of 8 so every full
#: chunk contributes a whole number of bytes at any width (chunk*bits % 8
#: == 0) and chunks concatenate without bit realignment. Bounds the
#: (chunk, bits) intermediate to ~0.25 GB at 32-bit width — an hour-scale
#: file (~80 M live ranges) packs in constant memory instead of
#: materializing an (m, bits) uint64 tensor.
_BITPACK_CHUNK = 1 << 20


def _bounded_inflate(buf: bytes, expected: int) -> bytes:
    """zlib-inflate `buf`, refusing to produce more than `expected` bytes.

    zlib.decompress(bufsize=...) treats the size only as an initial buffer
    hint, so a crafted stream could balloon to arbitrary memory before the
    post-hoc length check; decompressobj with max_length bounds allocation
    to the header-validated size.
    """
    d = zlib.decompressobj()
    try:
        # max_length=0 would mean "unlimited"; for expected==0 cap at one
        # byte and let the length check below reject any output at all
        out = d.decompress(buf, expected or 1)
    except zlib.error as e:
        raise ValueError("Corrupt or truncated FWAV payload") from e
    if d.unconsumed_tail or not d.eof or len(out) != expected:
        raise ValueError("Corrupt or truncated FWAV payload")
    return out


def _pack_bits(values: np.ndarray, bits: int) -> bytes:
    """LSB-first bit-pack non-negative int values at fixed width. Native
    fast path (fwav_pack_bits, byte-identical — the numpy matrix build
    below moves ~15 bytes per packed bit and dominates hour-scale compact
    writes); numpy kept as the executable spec and fallback."""
    m = len(values)
    if m == 0 or bits == 0:
        return b""
    from . import native

    nat = native.pack_bits(values, bits)
    if nat is not None:
        return nat
    shifts = np.arange(bits, dtype=np.uint64)[None, :]
    out = []
    for i in range(0, m, _BITPACK_CHUNK):
        v = values[i : i + _BITPACK_CHUNK].astype(np.uint64)
        b = ((v[:, None] >> shifts) & 1).astype(np.uint8)
        out.append(np.packbits(b.reshape(-1), bitorder="little").tobytes())
    return b"".join(out)


def _unpack_bits(buf: bytes, m: int, bits: int) -> np.ndarray:
    if m == 0 or bits == 0:
        return np.zeros(m, np.int64)
    if len(buf) < (m * bits + 7) // 8:
        # np.unpackbits(count=...) zero-pads a short buffer instead of
        # raising, which would decode a truncated stream as silent zero
        # indices; enforce the length contract before either backend runs
        raise ValueError("Truncated FWAV idx stream")
    from . import native

    nat = native.unpack_bits(buf, m, bits)
    if nat is not None:
        return nat
    w = 1 << np.arange(bits, dtype=np.int64)
    a = np.frombuffer(buf, np.uint8)
    res = np.empty(m, np.int64)
    step_bytes = _BITPACK_CHUNK * bits // 8
    for i in range(0, m, _BITPACK_CHUNK):
        mc = min(_BITPACK_CHUNK, m - i)
        chunk = a[i // _BITPACK_CHUNK * step_bytes :][: (mc * bits + 7) // 8]
        raw = np.unpackbits(chunk, count=mc * bits, bitorder="little")
        res[i : i + mc] = raw.reshape(mc, bits) @ w
    return res


def _pack_mask(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(np.uint8), bitorder="little").tobytes()


def _unpack_mask(buf: bytes, m: int) -> np.ndarray:
    if m == 0:
        return np.zeros(0, bool)
    return np.unpackbits(
        np.frombuffer(buf, np.uint8), count=m, bitorder="little"
    ).astype(bool)


def _scale_exp_for(values) -> int:
    """Exponent k landing max|values| / 2^k in (8192, 16384] (ceil(log2)
    semantics: an exact power-of-two peak lands ON the upper edge, the same
    half-open-at-the-bottom window convention as _o_exp_for) — an exact
    power-of-2 rescale (only fp exponents change) that gives every stored
    element full float16 relative precision regardless of content scale.
    Clamped to the int8 ext-header field / normal-float32 scale range:
    subnormal-float32 peaks (below ~2^-112) store with reduced precision
    instead of crashing the writer."""
    import math

    peak = float(np.max(np.abs(values))) if np.size(values) else 0.0
    if peak <= 0.0 or not np.isfinite(peak):
        return 0
    return max(-126, min(126, int(math.ceil(math.log2(peak))) - 14))


def _o_exp_for(values) -> int:
    """Exponent k landing max|values| / 2^k in (16384, 32768] — the int16
    fixed-point window (one bit wider than the float16 one): worst-case
    rounding error is then peak * 2^-15, i.e. 0.5 LSB on full-scale 16-bit
    PCM offsets. Same int8/normal-f32 clamping as _scale_exp_for."""
    import math

    peak = float(np.max(np.abs(values))) if np.size(values) else 0.0
    if peak <= 0.0:
        return 0
    if not np.isfinite(peak):
        raise ValueError(
            "non-finite offsets cannot be stored in the compact container"
        )
    return max(-126, min(126, int(math.ceil(math.log2(peak))) - 15))


def _pow2(exp: int) -> np.float32:
    return np.float32(2.0 ** exp)


def _byteplane(buf: bytes) -> bytes:
    """Split an fp16 stream into its low-byte plane then high-byte plane."""
    a = np.frombuffer(buf, np.uint8)
    return a[0::2].tobytes() + a[1::2].tobytes()


def _unbyteplane(buf: bytes) -> bytes:
    a = np.frombuffer(buf, np.uint8)
    h = len(a) // 2
    out = np.empty(len(a), np.uint8)
    out[0::2] = a[:h]
    out[1::2] = a[h:]
    return out.tobytes()


def _zigzag(d: np.ndarray) -> np.ndarray:
    return ((d << 1) ^ (d >> 63)).astype(np.int64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return (z >> 1) ^ -(z & 1)


def _idx_delta_encode(idx: np.ndarray) -> np.ndarray:
    """zigzag(first-difference); element 0 is zigzag(idx[0])."""
    d = np.diff(idx.astype(np.int64), prepend=np.int64(0))
    return _zigzag(d)


def _idx_delta_decode(zz: np.ndarray) -> np.ndarray:
    return np.cumsum(_unzigzag(zz.astype(np.int64))).astype(np.int64)


# --- round-4 entropy layout (FLAG_ENTROPY) --------------------------------

#: ext2 header appended after the 16-byte ext when FLAG_ENTROPY is set:
#: o_shift u8, s_drop u8, idx_enc u8 (0 = plain packed, 1 = dense symbol
#: rANS, 2 = rank-split rANS — see below), so_enc u8 (bit0: s is ONE
#: whole-value rANS stream instead of hi/lo byte planes; bit1: same for
#: o — byte planes discard cross-byte correlation, measured worth 14 KB on
#: s for the 10 s bench fixture), then u32 lengths: deflated header
#: section, idx stream, s hi/lo, o hi/lo. When a stream is whole-value
#: coded its "hi" field is the stream byte length and its "lo" field is
#: the ALPHABET SIZE (the sorted unique u16 values + their frequency table
#: live in the deflated header section). idx_enc=2 appends the _EXT2_RS
#: tail (u32 idx-hi stream length, u32 idx alphabet) — a conditional tail,
#: not a struct growth, so every pre-round-5 file (idx_enc 0/1) keeps its
#: exact byte layout and still parses.
#:
#: idx_enc=2 (round 5) covers the damped profile's wide selections: its
#: unique-domain count routinely exceeds the dense-table cap
#: (2^PROB_BITS), which used to fall all the way back to fixed-width
#: packing (measured 13 bits/live vs 10.3 bits of empirical idx entropy on
#: the damped bench fixture — a 34 KB / 7% file-size gap; a 12-bit-table
#: split cannot close it: near 1 slot/symbol every split base degenerates
#: to uniform, measured a tie with packing). Rank-split codes each live
#: match's RANK into the sorted unique-value list as two rANS streams —
#: rank & (2^_IDX_SPLIT_BITS - 1) (the "idx stream" slot) at 16-bit
#: probability resolution and rank >> _IDX_SPLIT_BITS (the idx-hi slot) at
#: the default resolution — so the lo table keeps >= 10 slots/symbol on
#: real alphabets and any unique count <= 2^24 stays codable. A split
#: stream whose alphabet is 1 is deterministic and stores NO bytes and NO
#: table (idx-hi in every file under 65537 uniques). The value list (u16,
#: or u32 when n_domains needs it — width derivable from the main header)
#: and the present freq tables live in the deflated header section. The
#: writer keeps it only when it beats packing, like every other layout
#: choice.
_EXT2 = struct.Struct("<BBBBIIIIII")
#: Conditional ext2 tail, present exactly when idx_enc == 2: idx-hi stream
#: byte length, rank alphabet (count of distinct referenced bank rows).
_EXT2_RS = struct.Struct("<II")

#: Quantization budget: the added decode noise from o_shift and from s_drop
#: must EACH stay under this fraction of the encoder's measured residual
#: energy (sum err^2 — a LOWER bound on every decoder's distortion, since
#: err^2 = ||r_c||^2 - gain <= ||r - o||^2 and <= the stored-transform
#: residual). Both together bound the round-trip SNR cost at
#: 10*log10(1 + 2*gamma) ~ 0.026 dB; measured < 0.01 dB on every fixture
#: (tests/test_compact.py::test_entropy_quantization_cost).
_QUANT_GAMMA = 0.003

#: Symbol-level rANS for the idx stream needs the dense frequency table to
#: stay small and the observed alphabet under the 2^PROB_BITS cap.
_IDX_RANS_MAX_DOMAINS = 1 << 16

#: idx_enc=2 rank-split base AND the lo stream's probability resolution
#: (see the _EXT2 doc). 16 = rans.MAX_PROB_BITS: the widest table the u16
#: frequency format holds, so the lo alphabet never outruns its table.
_IDX_SPLIT_BITS = 16


def _pick_o_shift(o16: np.ndarray, o_exp: int, range_size: int,
                  anchor: float) -> int:
    """Largest power-of-2 offset quantization step whose added decode noise
    (exact: the default decode's output IS o per sample, and the damped
    decode adds the same per-sample offset error) fits the budget."""
    if anchor <= 0 or not np.isfinite(anchor) or len(o16) == 0:
        return 0
    budget = _QUANT_GAMMA * anchor
    scale2 = float(_pow2(o_exp)) ** 2
    best = 0
    for k in range(1, 13):
        q = np.rint(o16 * (1.0 / (1 << k)))
        e = o16 - q * (1 << k)
        added = range_size * float(np.dot(e, e)) * scale2
        if added <= budget:
            best = k
        else:
            break
    return best


def _quant_s_u16(s_u16: np.ndarray, drop: int) -> np.ndarray:
    """Round `drop` low mantissa bits off fp16 bit patterns (sign-magnitude:
    magnitude rounding may carry into the exponent, which is valid IEEE —
    clamped below inf)."""
    if drop == 0:
        return s_u16
    mag = (s_u16 & 0x7FFF).astype(np.int64)
    mag = ((mag + (1 << (drop - 1))) >> drop) << drop
    mag = np.minimum(mag, 0x7BFF)  # largest finite fp16
    return ((s_u16 & 0x8000) | mag.astype(np.uint16)).astype(np.uint16)


def _pick_s_drop(s_u16: np.ndarray, s_f32: np.ndarray, d_energy: np.ndarray,
                 anchor: float) -> int:
    """Largest fp16 mantissa drop for the scale stream whose added
    stored-transform decode noise sum((s - s_hat)^2 * ||d||^2) fits the
    budget (||d||^2 uncentered covers the default decoder's degenerate-tile
    use of stored s as well)."""
    if anchor <= 0 or not np.isfinite(anchor) or len(s_u16) == 0:
        return 0
    budget = _QUANT_GAMMA * anchor
    best = 0
    for d in range(1, 11):
        s_hat = np.frombuffer(
            _quant_s_u16(s_u16, d).tobytes(), np.float16
        ).astype(np.float64)
        e = s_f32.astype(np.float64) - s_hat
        if float(np.dot(e * e, d_energy)) <= budget:
            best = d
        else:
            break
    return best


def _entropy_variant(rec, live, n_live, idx, o16, bq, bank_planes, live_b,
                     sym_b, o_exp, bank_exp, idx_bits, range_size,
                     n_domains, idx_plain):
    """Assemble the FLAG_ENTROPY (ext2 + rANS streams) encoding, or None
    when it does not apply (no live matches). Returns
    (zraw_len, ext2, payload) — zraw_len is the uncompressed header-section
    length stored as the ext raw_len field; the caller compares payload
    sizes against the legacy variants."""
    from . import rans

    if n_live == 0:
        return None
    err = rec["err"][live].astype(np.float64)
    err = err[np.isfinite(err)]
    anchor = float(np.dot(err, err)) if len(err) else 0.0

    o_shift = _pick_o_shift(o16, o_exp, range_size, anchor)
    oq = np.rint(o16 * (1.0 / (1 << o_shift))).astype(np.int64)
    ozz = _zigzag(oq)

    s_u16 = np.frombuffer(
        rec["s"][live].astype(np.float16).tobytes(), np.uint16
    )
    rows = rec["idx"][live].astype(np.int64)
    # ||d||^2 at RAW scale: bq is the fp16 bank scaled by 2^-bank_exp, so
    # the energy needs the 2^(2*bank_exp) factor back — without it the
    # s-drop noise budget is off by 4^bank_exp (measured 4.8 dB of decode
    # loss on content peaking near 2^20 where bank_exp = 7, and an always-
    # zero s_drop on float content near +/-1 where bank_exp = -14)
    d_energy = (
        (bq[rows].astype(np.float64) ** 2).sum(axis=1)
        * float(_pow2(bank_exp)) ** 2
    )
    s_drop = _pick_s_drop(s_u16, rec["s"][live], d_energy, anchor)
    s_q = _quant_s_u16(s_u16, s_drop).astype(np.int64)

    def plane_streams(vals):
        out = []
        for plane in (vals & 0xFF, (vals >> 8) & 0xFF):
            f = rans.quantize_freqs(np.bincount(plane, minlength=256))
            out.append((rans.serialize_freqs(f), rans.encode(plane, f)))
        return out

    def symbol_stream(vals):
        """Whole-value coding: rANS over ranks into the sorted unique-value
        list (values + freqs both land in the deflated header section).
        None when the alphabet exceeds the coder's 2^PROB_BITS cap or u16
        value range. Hour-scale streams pay a full-length sort here, so a
        bounded prefix probe rejects the hopeless case (a wide-alphabet
        prefix can only widen) before the full unique()."""
        if len(vals) > (1 << 22):
            if len(np.unique(vals[: 1 << 20])) > (1 << rans.PROB_BITS):
                return None
        u, inv = np.unique(vals, return_inverse=True)
        if len(u) > (1 << rans.PROB_BITS) or (
            len(u) and (int(u.min()) < 0 or int(u.max()) > 0xFFFF)
        ):
            return None
        f = rans.quantize_freqs(np.bincount(inv, minlength=len(u)))
        return (
            u.astype("<u2").tobytes() + rans.serialize_freqs(f),
            rans.encode(inv, f),
            len(u),
        )

    (s_lo_t, s_lo), (s_hi_t, s_hi) = plane_streams(s_q)
    (o_lo_t, o_lo), (o_hi_t, o_hi) = plane_streams(ozz)

    # per-stream keep-smallest between the byte-plane pair and the
    # whole-value stream (pre-deflate table sizes: both table families land
    # in the same deflated section, so the comparison bias is small)
    so_enc = 0
    s_sym = symbol_stream(s_q)
    if s_sym and len(s_sym[1]) + len(s_sym[0]) < len(s_hi) + len(s_lo) + 1024:
        so_enc |= 1
        s_tabs, s_hi, s_lo_n = s_sym
    o_sym = symbol_stream(ozz)
    if o_sym and len(o_sym[1]) + len(o_sym[0]) < len(o_hi) + len(o_lo) + 1024:
        so_enc |= 2
        o_tabs, o_hi, o_lo_n = o_sym

    idx_enc = 0
    idx_tab = b""
    idx_hi = b""
    idx_alpha = 0
    # one sort serves both the dense gate and the rank-split ranks
    u, inv = np.unique(idx, return_inverse=True)
    if n_domains <= _IDX_RANS_MAX_DOMAINS and len(u) <= (1 << rans.PROB_BITS):
        f_idx = rans.quantize_freqs(np.bincount(idx, minlength=n_domains))
        idx_tab = rans.serialize_freqs(f_idx)
        idx_stream = rans.encode(idx, f_idx)
        idx_enc = 1
    else:
        # the legacy-layout probe already packed idx at idx_bits — the SAME
        # value _parse_entropy recomputes from the header, so the packed
        # width can never drift between writer and reader; reuse it as the
        # fallback (repacking measured ~4.5 s/8M ranges before the native
        # pack), but try rank-split rANS first (idx_enc=2, see _EXT2 doc:
        # the dense-table gate above fails exactly on the damped profile's
        # wide selections, where packing wastes ~2.7 bits/live)
        idx_stream = idx_plain
        split = 1 << _IDX_SPLIT_BITS
        lo_alpha = min(len(u), split)
        hi_alpha = -(-len(u) // split)
        # an alphabet-1 split stream is deterministic: no stream, no table
        # (and quantize_freqs at 16 bits could not represent its frequency)
        lo_s = tab_lo = b""
        if lo_alpha > 1:
            f_lo = rans.quantize_freqs(
                np.bincount(inv & (split - 1), minlength=lo_alpha),
                _IDX_SPLIT_BITS,
            )
            lo_s = rans.encode(inv & (split - 1), f_lo, _IDX_SPLIT_BITS)
            tab_lo = rans.serialize_freqs(f_lo)
        hi_s = tab_hi = b""
        if hi_alpha > 1:
            f_hi = rans.quantize_freqs(
                np.bincount(inv >> _IDX_SPLIT_BITS, minlength=hi_alpha)
            )
            hi_s = rans.encode(inv >> _IDX_SPLIT_BITS, f_hi)
            tab_hi = rans.serialize_freqs(f_hi)
        w = 2 if n_domains <= (1 << 16) else 4
        tab2 = (
            u.astype("<u2" if w == 2 else "<u4").tobytes() + tab_lo + tab_hi
        )
        if len(lo_s) + len(hi_s) + len(tab2) < len(idx_plain):
            idx_enc, idx_alpha = 2, len(u)
            idx_stream, idx_hi, idx_tab = lo_s, hi_s, tab2

    zsec_raw = (
        bank_planes + live_b + sym_b + idx_tab
        + (s_tabs if so_enc & 1 else s_hi_t + s_lo_t)
        + (o_tabs if so_enc & 2 else o_hi_t + o_lo_t)
    )
    # same level valve as the legacy stage: hour-scale banks drop to
    # level 1 (~100 MB/s) instead of minutes of level-6 host time
    zsec = zlib.compress(zsec_raw, 6 if len(zsec_raw) <= (64 << 20) else 1)
    ext2 = _EXT2.pack(
        o_shift, s_drop, idx_enc, so_enc, len(zsec), len(idx_stream),
        len(s_hi), s_lo_n if so_enc & 1 else len(s_lo),
        len(o_hi), o_lo_n if so_enc & 2 else len(o_lo),
    )
    if idx_enc == 2:
        ext2 += _EXT2_RS.pack(len(idx_hi), idx_alpha)
    payload = (
        zsec + idx_stream + idx_hi + s_hi + (b"" if so_enc & 1 else s_lo)
        + o_hi + (b"" if so_enc & 2 else o_lo)
    )
    return len(zsec_raw), ext2, payload


def save_compressed_compact(
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
    decode_damping=None,
) -> None:
    """Write the v2 compact container. Same signature as
    io.container.save_compressed; callers normally prune the bank first
    (models.encode.prune_bank) — idx_bits is derived from the stored bank,
    so an unpruned bank only costs width, never correctness.
    decode_damping (optional) stores the FLAG_DECODE_HINT byte: the
    s_damping this file's matches were tuned for (the damped encode
    profile sets 0.25); hint-aware decoders default to it."""
    blob = compact_bytes(
        matches, domains_array, range_size, framerate, sampwidth,
        tile_size, domain_step, energy_threshold, original_len,
        decode_damping=decode_damping,
    )
    with open(filepath, "wb") as f:
        f.write(blob)


def compact_bytes(
    matches,
    domains_array,
    range_size,
    framerate,
    sampwidth,
    tile_size,
    domain_step,
    energy_threshold,
    original_len,
    decode_damping=None,
) -> bytes:
    """Encode one channel's decode inputs as a complete, self-checking v2
    container blob (header + SHA-256 + ext + payload). save_compressed_compact
    writes exactly these bytes; the v3 multichannel container (io.multich)
    embeds one such blob per stored channel. decode_damping != None stores
    the FLAG_DECODE_HINT byte (see the flag comment)."""
    rec = matches_to_struct(matches)
    domains = np.ascontiguousarray(np.asarray(domains_array, dtype=np.float32))
    n_ranges = len(rec)
    n_domains = len(domains)

    live = rec["idx"] >= 0
    n_live = int(live.sum())
    idx = rec["idx"][live].astype(np.int64)
    if n_live and idx.max() >= n_domains:
        raise ValueError("match indices exceed the stored bank")
    idx_bits = max(1, int(max(n_domains - 1, 1)).bit_length())

    bank_exp = _scale_exp_for(domains)
    o_exp = _o_exp_for(rec["o"][live]) if n_live else 0

    header = (
        MAGIC
        + struct.pack("<B", COMPACT_VERSION)
        + _HEADER.pack(
            int(range_size), int(framerate), int(sampwidth), int(tile_size),
            int(domain_step), float(energy_threshold), int(n_ranges),
            int(n_domains), int(original_len),
        )
    )
    bank_q = (domains * _pow2(-bank_exp)).astype(np.float16)
    bank_b = bank_q.tobytes()
    live_b = _pack_mask(live)
    sym_b = _pack_mask(rec["sym"][live] != 0)
    s_b = rec["s"][live].astype(np.float16).tobytes()
    # saturate: the scaled peak rounds to at most 32768 (window edge) —
    # one count above int16 max, clipped at 1 ulp cost on that sample
    o16 = np.clip(
        np.round(rec["o"][live].astype(np.float64) * 2.0 ** -o_exp),
        -32767, 32767,
    ).astype(np.int64)
    o_b = o16.astype(np.int16).tobytes()

    # Keep-smallest over {raw, deflate(+idx-delta), entropy}, ordered so the
    # usual winner is priced first and the losers' cost is mostly skipped
    # (round 5: the legacy level-6 deflate of the full streams was the
    # single biggest write cost — 55 ms of the 162 ms fixture write — while
    # the entropy layout beat it by 20-40% on every measured fixture).
    idx_plain = _pack_bits(idx, idx_bits)
    raw = bank_b + live_b + sym_b + idx_plain + s_b + o_b
    flags, payload, raw_len, ext2 = 0, raw, len(raw), b""

    # round-4 entropy variant (rANS streams + distortion-bounded o/s
    # quantization): usually the winner, but degenerate content (tiny
    # files, incompressible selections) keeps the legacy bytes
    bank_planes = _byteplane(bank_b)
    ent = _entropy_variant(
        rec, live, n_live, idx, o16, bank_q, bank_planes, live_b, sym_b,
        o_exp, bank_exp, idx_bits, range_size, n_domains, idx_plain,
    )
    if ent is not None:
        zraw_len, e_ext2, e_payload = ent
        if len(e_ext2) + len(e_payload) < len(raw):
            flags = FLAG_ENTROPY
            ext2, payload, raw_len = e_ext2, e_payload, zraw_len

    # Legacy deflate stage: byteplane the fp16 streams and deflate. The idx
    # stream is the one transform choice that depends on content (plain
    # packing vs zigzag first-differences); decide it by probing a bounded
    # prefix of the idx stream alone. Price the full streams at level 1
    # first (a valid FLAG_DEFLATE stream in itself, ~7x cheaper); only pay
    # level 6 when level 1 lands within 5% of the current winner — measured
    # level-6 gain over level 1 on these streams is ~1.5% (hour-scale
    # payloads always stayed at level 1, docstring above), so a >5% gap is
    # unreachable and the expensive compress is skipped, usually entirely.
    probe = 4 << 20
    idx_delta = _pack_bits(_idx_delta_encode(idx), idx_bits + 1)
    if len(zlib.compress(idx_delta[:probe], 1)) < len(
        zlib.compress(idx_plain[:probe], 1)
    ):
        dflags, idx_stream = FLAG_DEFLATE | FLAG_IDX_DELTA, idx_delta
    else:
        dflags, idx_stream = FLAG_DEFLATE, idx_plain
    planes = (
        bank_planes + live_b + sym_b + idx_stream
        + _byteplane(s_b) + _byteplane(o_b)
    )
    best = len(ext2) + len(payload)
    z = zlib.compress(planes, 1)
    if len(planes) <= (64 << 20) and len(z) < best * 1.05:
        z6 = zlib.compress(planes, 6)
        if len(z6) < len(z):
            z = z6
    if len(z) < best:
        flags, ext2, payload, raw_len = dflags, b"", z, len(planes)

    hint = b""
    if decode_damping is not None:
        if not np.isfinite(decode_damping):
            raise ValueError(f"decode_damping hint not finite: {decode_damping}")
        q = int(round(float(decode_damping) * 100.0))
        if not 0 <= q <= 255:
            raise ValueError(
                f"decode_damping hint out of range [0, 2.55]: {decode_damping}"
            )
        flags |= FLAG_DECODE_HINT
        hint = struct.pack("<B", q)
    ext = _EXT.pack(
        idx_bits, bank_exp, o_exp, flags | FLAG_O_INT16, n_live, raw_len
    )
    sha = hashlib.sha256()
    sha.update(ext)
    sha.update(hint)
    sha.update(ext2)
    sha.update(payload)
    return header + sha.digest() + ext + hint + ext2 + payload


def parse_decode_hint(data: bytes):
    """Return the stored FLAG_DECODE_HINT value (the writer's preferred
    decoder s_damping) of a v2 blob, or None when absent / not a v2 blob.
    Needs only the first _EXT_OFFSET + 17 bytes — callers may pass a file
    prefix. Purely advisory, so unlike the loaders this never raises on a
    malformed prefix."""
    if len(data) < _EXT_OFFSET + _EXT.size or data[:4] != MAGIC:
        return None
    if data[4] != COMPACT_VERSION:
        return None
    flags = _EXT.unpack(data[_EXT_OFFSET : _EXT_OFFSET + _EXT.size])[3]
    pos = _EXT_OFFSET + _EXT.size
    if not flags & FLAG_DECODE_HINT or len(data) <= pos:
        return None
    return data[pos] / 100.0


def load_compressed_compact(filepath, verify_checksum: bool = True):
    """Load a v2 container; returns the same 10-tuple as
    io.container.load_compressed_arrays (err is 0 — not stored, see module
    docstring)."""
    with open(filepath, "rb") as f:
        return parse_compact_bytes(f.read(), verify_checksum=verify_checksum)


def parse_compact_bytes(data: bytes, verify_checksum: bool = True):
    """Parse one v2 container blob (the bytes compact_bytes produces) into
    the load_compressed_arrays 10-tuple. Shared by the file loader and the
    v3 multichannel container's per-channel sections."""
    head = data[:_EXT_OFFSET]
    body = data[_EXT_OFFSET:]
    if len(head) < _EXT_OFFSET:
        raise ValueError("Not a FWAV file" if head[:4] != MAGIC
                         else "Truncated FWAV payload")
    if head[:4] != MAGIC:
        raise ValueError("Not a FWAV file")
    if head[4] != COMPACT_VERSION:
        raise ValueError(f"Not a compact FWAV container (version {head[4]})")
    (
        range_size, framerate, sampwidth, tile_size, domain_step,
        energy_threshold, n_ranges, n_domains, original_len,
    ) = _HEADER.unpack(head[5 : 5 + _HEADER.size])
    stored = head[_CHECKSUM_OFFSET : _CHECKSUM_OFFSET + 32]
    if verify_checksum and hashlib.sha256(body).digest() != stored:
        raise ValueError("Checksum mismatch — file may be corrupted")

    if len(body) < _EXT.size:
        raise ValueError("Truncated FWAV payload")
    idx_bits, bank_exp, o_exp, flags, n_live, raw_len = _EXT.unpack(
        body[: _EXT.size]
    )
    if flags & ~(FLAG_DEFLATE | FLAG_IDX_DELTA | FLAG_O_INT16 | FLAG_ENTROPY
                 | FLAG_DECODE_HINT):
        # a future stream encoding must fail loudly on this loader, never
        # decode to plausible garbage (the FLAG_O_INT16 transition is the
        # in-repo precedent for exactly that hazard)
        raise ValueError(f"Unknown compact FWAV flags: 0x{flags:02x}")
    base = _EXT.size
    if flags & FLAG_DECODE_HINT:
        # advisory byte for the decoder's s_damping default; stream layout
        # is unchanged apart from the one-byte shift
        if len(body) < base + 1:
            raise ValueError("Truncated FWAV payload")
        base += 1
    hdr = (range_size, framerate, sampwidth, tile_size, domain_step,
           energy_threshold, n_ranges, n_domains, original_len)
    if flags & FLAG_ENTROPY:
        if flags & (FLAG_DEFLATE | FLAG_IDX_DELTA):
            raise ValueError(f"Unknown compact FWAV flags: 0x{flags:02x}")
        return _parse_entropy(body, hdr, idx_bits, bank_exp, o_exp, n_live,
                              raw_len, base)

    eff_idx_bits = idx_bits + 1 if flags & FLAG_IDX_DELTA else idx_bits
    sizes = [
        n_domains * range_size * 2,
        (n_ranges + 7) // 8,
        (n_live + 7) // 8,
        (n_live * eff_idx_bits + 7) // 8,
        n_live * 2,
        n_live * 2,
    ]
    expected = sum(sizes)
    payload = body[base:]
    if flags & FLAG_DEFLATE:
        # validate the stored length against the header-derived size BEFORE
        # allocating: a corrupt raw_payload_len must raise the format's
        # ValueError, not pre-allocate a u64's worth of buffer (MemoryError)
        if raw_len != expected:
            raise ValueError("Corrupt or truncated FWAV payload")
        # truncation and bit-flips both surface inside _bounded_inflate:
        # the zlib stream carries its own adler32, so deflated payloads
        # stay corruption-checked even when the SHA-256 pass is skipped
        payload = _bounded_inflate(payload, expected)
    if len(payload) != expected:
        raise ValueError("Truncated FWAV payload")
    parts = []
    off = 0
    for sz in sizes:
        parts.append(payload[off : off + sz])
        off += sz
    bank_b, live_b, sym_b, idx_b, s_b, o_b = parts
    if flags & FLAG_DEFLATE:
        bank_b, s_b, o_b = map(_unbyteplane, (bank_b, s_b, o_b))

    domains = (
        np.frombuffer(bank_b, np.float16).astype(np.float32) * _pow2(bank_exp)
    ).reshape(n_domains, range_size)
    live = _unpack_mask(live_b, n_ranges)
    if int(live.sum()) != n_live:
        raise ValueError("Corrupt FWAV live bitmap")

    rec = np.zeros(n_ranges, dtype=MATCH_DTYPE)
    rec["idx"] = -1
    rec["s"] = 1.0
    if n_live:
        packed = _unpack_bits(idx_b, n_live, eff_idx_bits)
        if flags & FLAG_IDX_DELTA:
            packed = _idx_delta_decode(packed)
        # mirror the writer's invariant: a corrupt idx stream (possible on
        # raw-layout files with the SHA pass skipped) must not pass
        # out-of-range or negative indices to decoders
        if packed.size and (
            int(packed.min()) < 0 or int(packed.max()) >= n_domains
        ):
            raise ValueError("Corrupt FWAV idx stream")
        rec["idx"][live] = packed.astype(np.int32)
        rec["sym"][live] = _unpack_mask(sym_b, n_live)
        rec["s"][live] = np.frombuffer(s_b, np.float16).astype(np.float32)
        o_dtype = np.int16 if flags & FLAG_O_INT16 else np.float16
        rec["o"][live] = (
            np.frombuffer(o_b, o_dtype).astype(np.float32) * _pow2(o_exp)
        )
    return (
        rec, domains, n_ranges, range_size, framerate, sampwidth, tile_size,
        domain_step, energy_threshold, original_len,
    )


def _parse_entropy(body, hdr, idx_bits, bank_exp, o_exp, n_live, raw_len,
                   base=_EXT.size):
    """Parse the FLAG_ENTROPY layout (see _entropy_variant): ext2 header,
    deflated header section (bank planes + bitmaps + rANS tables), then the
    five rANS / packed streams. `base` is the ext2 offset into body (one
    past _EXT.size when the FLAG_DECODE_HINT byte is present)."""
    from . import rans

    (range_size, framerate, sampwidth, tile_size, domain_step,
     energy_threshold, n_ranges, n_domains, original_len) = hdr
    off = base
    if len(body) < off + _EXT2.size:
        raise ValueError("Truncated FWAV payload")
    (o_shift, s_drop, idx_enc, so_enc, z_len, idx_len, s_hi_len, s_lo_len,
     o_hi_len, o_lo_len) = _EXT2.unpack(body[off : off + _EXT2.size])
    del s_drop  # applied at write time; stored patterns are already final
    if o_shift > 12:  # writer emits 0..12 (_pick_o_shift) — fail loudly on
        raise ValueError("Corrupt compact FWAV o_shift")  # a flipped byte
    if so_enc & ~3:  # same discipline as the flags byte: a future stream
        raise ValueError(  # encoding must never decode to plausible garbage
            f"Unknown compact FWAV stream encoding: 0x{so_enc:02x}"
        )
    if idx_enc > 2:
        raise ValueError(f"Unknown compact FWAV idx encoding: {idx_enc}")
    off += _EXT2.size
    idx_hi_len = idx_alpha = 0
    if idx_enc == 2:
        # conditional tail (see _EXT2_RS): pre-round-5 layouts stay intact
        if len(body) < off + _EXT2_RS.size:
            raise ValueError("Truncated FWAV payload")
        idx_hi_len, idx_alpha = _EXT2_RS.unpack(body[off : off + _EXT2_RS.size])
        off += _EXT2_RS.size
    # whole-value-coded streams repurpose their "lo" field as the alphabet
    # size (the value list + freq table live in the deflated section)
    s_alpha = s_lo_len if so_enc & 1 else 0
    o_alpha = o_lo_len if so_enc & 2 else 0
    alpha_cap = 1 << rans.PROB_BITS  # the writer's symbol_stream gate
    if (so_enc & 1 and not 1 <= s_alpha <= alpha_cap) or (
        so_enc & 2 and not 1 <= o_alpha <= alpha_cap
    ):
        raise ValueError("Corrupt compact FWAV alphabet size")
    if idx_enc == 2 and not 1 <= idx_alpha <= min(n_domains, n_live):
        # rank-split alphabet is the count of DISTINCT referenced rows
        raise ValueError("Corrupt compact FWAV alphabet size")
    if idx_enc == 2:
        # alphabet-1 split streams are deterministic: stored bytes there
        # are unaccounted-for garbage, not a decodable layout
        if idx_alpha <= 1 and idx_len:
            raise ValueError("Corrupt compact FWAV idx fields")
        if idx_alpha <= (1 << _IDX_SPLIT_BITS) and idx_hi_len:
            raise ValueError("Corrupt compact FWAV idx fields")
    lens = [z_len, idx_len, idx_hi_len, s_hi_len,
            0 if so_enc & 1 else s_lo_len,
            o_hi_len, 0 if so_enc & 2 else o_lo_len]
    if len(body) - off != sum(lens):
        raise ValueError("Corrupt or truncated FWAV payload")
    segs = []
    for ln in lens:
        segs.append(body[off : off + ln])
        off += ln
    zsec_b, idx_b, idx_hi_b, s_hi_b, s_lo_b, o_hi_b, o_lo_b = segs

    w_idx = 2 if n_domains <= (1 << 16) else 4
    idx_lo_alpha = min(idx_alpha, 1 << _IDX_SPLIT_BITS)
    idx_hi_alpha = -(-idx_alpha // (1 << _IDX_SPLIT_BITS)) if idx_alpha else 0
    if idx_enc == 2:
        # alphabet-1 split streams store no freq table (see the _EXT2 doc)
        idx_tab_bytes = (
            w_idx * idx_alpha
            + (2 * idx_lo_alpha if idx_lo_alpha > 1 else 0)
            + (2 * idx_hi_alpha if idx_hi_alpha > 1 else 0)
        )
    else:
        idx_tab_bytes = 2 * n_domains if idx_enc else 0
    tab_bytes = (
        idx_tab_bytes
        + (4 * s_alpha if so_enc & 1 else 1024)
        + (4 * o_alpha if so_enc & 2 else 1024)
    )
    expected = (
        n_domains * range_size * 2 + (n_ranges + 7) // 8
        + (n_live + 7) // 8 + tab_bytes
    )
    if raw_len != expected:
        raise ValueError("Corrupt or truncated FWAV payload")
    zsec = _bounded_inflate(zsec_b, expected)
    sizes = [n_domains * range_size * 2, (n_ranges + 7) // 8,
             (n_live + 7) // 8, idx_tab_bytes,
             4 * s_alpha if so_enc & 1 else 512,
             0 if so_enc & 1 else 512,
             4 * o_alpha if so_enc & 2 else 512,
             0 if so_enc & 2 else 512]
    parts, p = [], 0
    for sz in sizes:
        parts.append(zsec[p : p + sz])
        p += sz
    bank_b, live_b, sym_b, idx_tab, s_hi_t, s_lo_t, o_hi_t, o_lo_t = parts

    domains = (
        np.frombuffer(_unbyteplane(bank_b), np.float16).astype(np.float32)
        * _pow2(bank_exp)
    ).reshape(n_domains, range_size)
    live = _unpack_mask(live_b, n_ranges)
    if int(live.sum()) != n_live:
        raise ValueError("Corrupt FWAV live bitmap")

    rec = np.zeros(n_ranges, dtype=MATCH_DTYPE)
    rec["idx"] = -1
    rec["s"] = 1.0
    if n_live:
        def whole_values(tab, stream, alpha):
            # sorted unique u16 values, then their freq table (see ext2 doc)
            vals = np.frombuffer(tab[: 2 * alpha], "<u2").astype(np.int64)
            f = rans.parse_freqs(tab[2 * alpha :], alpha)
            return vals[rans.decode(stream, n_live, f)]

        try:
            if idx_enc == 2:
                # rank-split (see _EXT2 doc): value list + the present
                # lo/hi freq tables from the deflated section, two rANS
                # streams (lo at 16-bit resolution; an alphabet-1 stream
                # is deterministic zeros with no stored bytes)
                vals = np.frombuffer(
                    idx_tab[: w_idx * idx_alpha],
                    "<u2" if w_idx == 2 else "<u4",
                ).astype(np.int64)
                p0 = w_idx * idx_alpha
                if idx_lo_alpha > 1:
                    f_lo = rans.parse_freqs(
                        idx_tab[p0 : p0 + 2 * idx_lo_alpha],
                        idx_lo_alpha, _IDX_SPLIT_BITS,
                    )
                    p0 += 2 * idx_lo_alpha
                    ranks = rans.decode(
                        idx_b, n_live, f_lo, _IDX_SPLIT_BITS
                    )
                else:
                    ranks = np.zeros(n_live, np.int64)
                if idx_hi_alpha > 1:
                    f_hi = rans.parse_freqs(idx_tab[p0:], idx_hi_alpha)
                    ranks = ranks | (
                        rans.decode(idx_hi_b, n_live, f_hi)
                        << _IDX_SPLIT_BITS
                    )
                if ranks.size and int(ranks.max()) >= idx_alpha:
                    raise ValueError("Corrupt FWAV idx stream")
                idx = vals[ranks]
            elif idx_enc:
                f_idx = rans.parse_freqs(idx_tab, n_domains)
                idx = rans.decode(idx_b, n_live, f_idx)
            else:
                idx = _unpack_bits(idx_b, n_live, idx_bits)
            if so_enc & 1:
                s_v = whole_values(s_hi_t, s_hi_b, s_alpha)
            else:
                s_hi = rans.decode(
                    s_hi_b, n_live, rans.parse_freqs(s_hi_t, 256)
                )
                s_lo = rans.decode(
                    s_lo_b, n_live, rans.parse_freqs(s_lo_t, 256)
                )
                s_v = (s_hi << 8) | s_lo
            if so_enc & 2:
                o_zz = whole_values(o_hi_t, o_hi_b, o_alpha)
            else:
                o_hi = rans.decode(
                    o_hi_b, n_live, rans.parse_freqs(o_hi_t, 256)
                )
                o_lo = rans.decode(
                    o_lo_b, n_live, rans.parse_freqs(o_lo_t, 256)
                )
                o_zz = (o_hi << 8) | o_lo
        except ValueError as e:
            raise ValueError("Corrupt or truncated FWAV payload") from e
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_domains):
            raise ValueError("Corrupt FWAV idx stream")
        rec["idx"][live] = idx.astype(np.int32)
        rec["sym"][live] = _unpack_mask(sym_b, n_live)
        s_u16 = s_v.astype(np.uint16)
        rec["s"][live] = np.frombuffer(s_u16.tobytes(), np.float16).astype(
            np.float32
        )
        oq = _unzigzag(o_zz.astype(np.int64))
        rec["o"][live] = (
            oq.astype(np.float64) * float(1 << o_shift) * float(_pow2(o_exp))
        ).astype(np.float32)
    return (
        rec, domains, n_ranges, range_size, framerate, sampwidth, tile_size,
        domain_step, energy_threshold, original_len,
    )
