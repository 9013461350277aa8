"""Single-shot encode: compress_audio_arrays on one device.

The counterpart of fwav_tpu/models/encode.py's single-shot path
(`compress_audio_arrays` -> `_compress_fast` -> the mode="raw" core at
tp=1). `encode_core` is that core in eager PyTorch: normalize, device VAD,
ranges with the reflect-padded tail, then the search, then the sentinel
mask and the 3-byte idx codes. Only the codes leave the device; the host
half (`_finalize_encode`, `collect_idx_matches`, `prune_bank`), copied
from the JAX package, refits s, o, err and the orientation against the
host-built bank.

The search takes the JAX package's kernel path (EncoderConfig.use_pallas
there): "exact" is K1 over the whole bank; "coarse" with one lobe is K1
over the stride-subsampled bank, then K2 around each range's lobe;
"coarse" with several lobes (the damped profile always takes 4) is K3's
top-C lobes over the subsampled bank, then K2 once over all of them.
Geometry that the JAX kernel path does not cover raises
NotImplementedError, naming the ROADMAP.md item that will port it.

The streaming encode (models/stream.py) runs two more device programs,
the counterparts of the JAX core's mode="masked" and mode="global":
`encode_core_masked` (one time shard: the host VAD as packed bits,
window-local codes) and `encode_core_global` (the whole-file
global-candidate pass: K3 nomination, then the staged window refine of
ops/search.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderConfig
from ..io.container import MATCH_DTYPE
from ..ops.affine import affine_stats, refit_host, row_mean
from ..ops.domains import box_sums, build_bank, build_domains_host, n_domains_for
from ..ops.kernels import (
    pallas_blocks_ok,
    refine_blocks_ok,
    refine_window,
    search_scan,
    topc_scan,
)
from ..ops.search import _window_gains, domain_thresh, domain_weights, refine_from_lobes
from ..ops.vad import voiced_detection, voiced_mask
from ..utils.buckets import bucket
from ..utils.device import resolve_device

#: The 3-byte little-endian idx code of a dead range (sentinel).
IDX3_SENTINEL = 0xFFFFFF
#: Largest whole-file bank (rows) whose global pass ships rows as 3-byte
#: codes; beyond it both of its transfers are int32 with -1 for none. A
#: module attribute, read at each call, so that a test can drive the int32
#: branch.
PACK3_MAX_ROWS = (1 << 24) - 1


def pack3(code: torch.Tensor) -> torch.Tensor:
    """(m,) int32 codes -> (m, 3) uint8, little-endian."""
    return torch.stack(
        [(code >> s) & 0xFF for s in (0, 8, 16)], dim=1
    ).to(torch.uint8)


def unpack3(b3: torch.Tensor) -> torch.Tensor:
    """(m, 3) uint8 -> (m,) int32 rows, -1 where the sentinel, on the device."""
    b = b3.to(torch.int32)
    c = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return torch.where(c == IDX3_SENTINEL, -1, c)


def pack3_np(rows: np.ndarray) -> np.ndarray:
    """(m,) integer rows (< 0 = dead) -> (m, 3) uint8, host side."""
    code = np.where(rows < 0, IDX3_SENTINEL, rows).astype(np.int64)
    return np.stack(
        [code & 0xFF, (code >> 8) & 0xFF, (code >> 16) & 0xFF], axis=1
    ).astype(np.uint8)


def unpack3_np(b3: np.ndarray) -> np.ndarray:
    """(m, 3) uint8 -> (m,) int64 rows, -1 where the sentinel, host side."""
    b3 = b3.astype(np.int64)
    c = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
    return np.where(c == IDX3_SENTINEL, -1, c)


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


def _means_setup(raw_norm, n: int, block_len: int, stride: int, dc: int):
    """The box-mean sequence in the layout K2 reads (`means_ext`: a
    stride-wide zero lead, then a zero tail) and the stride-subsampled bank
    rows K1 scans (strided views of the sequence; the full bank is never
    built on this path)."""
    means = box_sums(raw_norm, block_len) * (1.0 / block_len)
    W = stride + stride // 4
    lane0 = stride - W // 2
    ls = lane0 + (W - 1) + (n - 1) * block_len + 1
    Lslice = -(-ls // 128) * 128
    Lext = -(-(stride + (dc - 1) * stride + Lslice) // 128) * 128
    k = min(means.shape[0], Lext - stride)
    means_ext = torch.cat([
        means.new_zeros(stride), means[:k], means.new_zeros(Lext - stride - k)
    ])
    span = (dc - 1) * stride + 1
    mp = means if means.shape[0] >= span + (n - 1) * block_len else means_ext[stride:]
    bank_sub = torch.stack(
        [mp[j * block_len : j * block_len + span : stride] for j in range(n)],
        dim=1,
    )
    return means_ext, bank_sub


def _resolve_search(cfg: EncoderConfig, range_size: int, db: int):
    """Search mode and coarse stride for a bucketed bank size: "auto" takes
    "coarse" once the bank dwarfs the refine windows."""
    block_len = cfg.tile_size // range_size
    stride = min(cfg.coarse_stride, max(1, block_len // 2))
    stride = 1 << (stride.bit_length() - 1)  # largest pow2 <= stride
    search_mode = cfg.search
    if search_mode == "auto":
        search_mode = (
            "coarse"
            if db >= max(cfg.auto_coarse_threshold, 256 * stride) and stride > 1
            else "exact"
        )
    return search_mode, stride


def _coarse_topc(cfg: EncoderConfig) -> int:
    """Coarse lobes per range: the damped objective takes at least 4 (the
    JAX package's damped profile rule)."""
    if cfg.objective == "damped":
        return max(cfg.coarse_topc, 4)
    return cfg.coarse_topc


def _plan_search(cfg: EncoderConfig, mb: int, db: int):
    """The search mode and stride, or NotImplementedError where the JAX
    kernel path would leave the kernels (its gates, mirrored)."""
    n = cfg.range_size
    if cfg.objective not in ("balanced", "affine", "damped"):
        raise ValueError(f"unknown objective {cfg.objective!r}")
    search_mode, stride = _resolve_search(cfg, n, db)
    if search_mode == "exact":
        # the JAX package runs K1 or, where its Mosaic block gate fails, the
        # lax.scan oracle: the same selection rule, so K1 serves both
        return search_mode, stride
    if search_mode == "topk":
        raise NotImplementedError(
            'search="topk" is not ported yet (ROADMAP.md: topk compatibility mode)'
        )
    if search_mode != "coarse":
        raise ValueError(f"unknown search mode {cfg.search!r}")
    topc = _coarse_topc(cfg)
    rblk = _pow2_divisor(mb, cfg.range_block)
    rb_rk = _pow2_divisor(rblk, 512)
    if topc > 1:
        # the JAX multi-lobe kernel path runs where the window refine's gate
        # holds: K3 (or, where its Mosaic block gate fails, the
        # gain_topk_scan oracle of the same selection rule), then K2 per lobe
        if db % stride or not refine_blocks_ok(rblk, rb_rk, stride, cfg.domain_step,
                                               cfg.objective, db):
            raise NotImplementedError(
                f"coarse search with {topc} lobes (stride {stride}, bank {db} "
                f"rows, {mb} ranges) takes the staged refine in the JAX "
                "package (coarse_refine_search), which is not ported yet "
                "(ROADMAP.md: staged refine_from_lobes and gain_topk_scan)"
            )
        return search_mode, stride
    prb = 512 if rblk % 512 == 0 else _pow2_divisor(rblk, 512)
    dc = db // stride
    cdblk = _pow2_divisor(dc, cfg.domain_block)
    # db=0 checks the geometry alone; the size cap is checked below
    geometry_ok = refine_blocks_ok(rblk, rb_rk, stride, cfg.domain_step,
                                   cfg.objective, 0)
    if db % stride or not pallas_blocks_ok(rblk, dc, prb, cdblk) or not geometry_ok:
        raise NotImplementedError(
            f"coarse geometry (stride {stride}, bank {db} rows, {mb} ranges) "
            "takes the staged refine in the JAX package, which is not ported "
            "yet (ROADMAP.md: staged refine_from_lobes and gain_topk_scan)"
        )
    if not refine_blocks_ok(rblk, rb_rk, stride, cfg.domain_step, cfg.objective, db):
        raise NotImplementedError(
            f"a {db}-row bank is over the window refine's 9 MB means cap "
            "(single-shot files over ~53 s at 44.1 kHz; ROADMAP.md: lifting "
            "the 9 MB cap)"
        )
    return search_mode, stride


def _norm(raw):
    """float32 signal and the 1/max|x| normalization (1 for silence)."""
    rawf = raw.to(torch.float32)
    scale = rawf.abs().max()
    return rawf, torch.where(scale > 0, torch.reciprocal(scale), 1.0)


def _run_search(ranges, raw_norm, n_domains: int, db: int, cfg: EncoderConfig,
                search_mode: str, stride: int):
    """(idx, score) per range: K1 over the whole bank ("exact"), or K1
    (one lobe) or K3 (several) over the subsampled bank, then K2 once
    around every lobe ("coarse")."""
    n = cfg.range_size
    dev = ranges.device
    r_c = ranges - row_mean(ranges)[:, None]
    if search_mode == "exact":
        bank = build_bank(raw_norm, cfg.tile_size, n, cfg.domain_step, db, n_domains)
        d_mean, d_denom = affine_stats(bank)
        valid = torch.arange(db, device=dev) < n_domains
        score, idx = search_scan(
            r_c, bank.T.contiguous(),
            domain_weights(d_mean, d_denom, n, cfg.objective), valid,
            domain_thresh(d_denom, cfg.objective, cfg.s_clip), cfg.s_clip,
        )
        return idx, score
    dc = db // stride
    block_len = cfg.tile_size // n
    means_ext, bank_sub = _means_setup(raw_norm, n, block_len, stride, dc)
    sub_mean, sub_denom = affine_stats(bank_sub)
    v_sub = torch.arange(dc, device=dev) * stride < n_domains
    scan_args = (
        r_c, bank_sub.T.contiguous(),
        domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub,
    )
    thresh = domain_thresh(sub_denom, cfg.objective, cfg.s_clip)
    topc = _coarse_topc(cfg)
    if topc == 1:
        score, cidx = search_scan(*scan_args, thresh, cfg.s_clip)
        lobes = torch.where(torch.isfinite(score), cidx, -1)
    else:
        # (M, topc), the transposed view of K3's output, as K2 takes it
        lobes = topc_scan(*scan_args, topc, thresh, cfg.s_clip)
    # one launch walks every lobe of a range; the earlier lobe wins ties
    r_score, r_idx = refine_window(
        means_ext, lobes, ranges, n_domains, stride, block_len, cfg.objective,
        cfg.s_clip,
    )
    return r_idx, r_score


def _finish(ranges, raw_norm, n_ranges: int, n_domains: int, inv, db: int,
            cfg: EncoderConfig, search_mode: str, stride: int):
    """The search, then the sentinel mask and the 3-byte codes: the part
    the raw and masked programs share (the JAX core's `finish` and
    `pack_out` at dp = tp = 1)."""
    idx, score = _run_search(ranges, raw_norm, n_domains, db, cfg, search_mode, stride)
    # sentinels: energy-pruned (mean power under 0.75 * thresh, on the
    # normalized scale), bucket-pad rows, and rows with no finite score
    mb = ranges.shape[0]
    r_pow = row_mean(ranges * ranges)
    thr_n = float(cfg.energy_thresh) * inv * inv
    r_valid = torch.arange(mb, device=ranges.device) < n_ranges
    silent = (r_pow < thr_n * 0.75) if cfg.fast_mode else torch.zeros_like(r_valid)
    dead = silent | ~r_valid | ~torch.isfinite(score)
    return pack3(torch.where(dead, IDX3_SENTINEL, idx).to(torch.int32))


def encode_core(raw, n_samples: int, n_ranges: int, n_domains: int, lb: int,
                db: int, cfg: EncoderConfig, search_mode: str, stride: int):
    """The device program: bucket-padded raw signal (int16 or float32, on
    the device) -> (lb // range_size, 3) uint8 idx codes, IDX3_SENTINEL
    for energy-pruned, padded and no-candidate ranges."""
    n = cfg.range_size
    nb = raw.shape[0]
    mb = lb // n
    rawf, inv = _norm(raw)
    mask = voiced_mask(rawf, n_samples, 2 * n, float(cfg.energy_thresh))
    weighted = rawf * (mask.to(torch.float32) * inv)
    if lb <= nb:
        base = weighted[:lb]
    else:
        base = torch.cat([weighted, weighted.new_zeros(lb - nb)])
    ranges = base.reshape(mb, n).clone()
    if n_samples % n:
        # reflect-pad the tail range: position p >= ns reads 2*ns - 2 - p
        last = (n_samples - 1) // n
        tpos = last * n + torch.arange(n, device=raw.device)
        refl = torch.where(tpos < n_samples, tpos, 2 * n_samples - 2 - tpos)
        ranges[last] = weighted[refl.clamp(0, nb - 1)]
    return _finish(ranges, rawf * inv, n_ranges, n_domains, inv, db, cfg,
                   search_mode, stride)


def _mask_weighted(raw, mask_bytes):
    """float32 window, its 1/max|x| and the normalized voiced-weighted
    window, from the host VAD's packed bits (little-endian within each
    byte, as np.packbits(..., bitorder="little") writes them): expanded
    with shifts and a reshape, no gather."""
    rawf, inv = _norm(raw)
    shifts = torch.arange(8, dtype=torch.uint8, device=raw.device)
    bits = (mask_bytes[:, None] >> shifts[None, :]) & 1
    return rawf, inv, rawf * (bits.reshape(-1).to(torch.float32) * inv)


def encode_core_masked(raw, mask_bytes, meta, lb: int, db: int,
                       cfg: EncoderConfig, search_mode: str, stride: int):
    """One streaming shard (the JAX core's mode="masked"): the window's
    raw samples (int16 or float32, bucket-padded to nb, on the device), the
    host VAD of the same samples as nb/8 packed bytes, and meta =
    (n_window_samples, range_offset, n_ranges, n_domains) as ints. The
    window is normalized by its own max|x|; the ranges are the lb weighted
    samples at range_offset (the host reflect-pads the file's tail before
    it cuts the windows); the bank is built from the unmasked window.
    Returns (lb // range_size, 3) uint8 codes of window-local rows."""
    n = cfg.range_size
    _, offset, n_ranges, n_domains = (int(v) for v in meta)
    rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
    off = min(max(offset, 0), raw.shape[0] - lb)  # lax.dynamic_slice's clamp
    ranges = weighted[off : off + lb].reshape(lb // n, n)
    return _finish(ranges, rawf * inv, n_ranges, n_domains, inv, db, cfg,
                   search_mode, stride)


def encode_core_global(raw, mask_bytes, meta, local_rows, lb: int, db: int,
                       cfg: EncoderConfig, stride: int, topc: int):
    """The whole-file global-candidate pass (the JAX core's mode="global").
    Inputs as encode_core_masked's for the whole reflect-padded file (meta
    = (n_samples, 0, n_ranges, n_domains_total)), plus each range's
    shard-local winner as a whole-file row: (lb // range_size, 3) uint8
    codes when db < PACK3_MAX_ROWS, else int32 with -1 for none.

    K3 nominates the top-`topc` rows of the stride-subsampled whole-file
    bank for every range; the staged window refine (ops/search.py
    refine_from_lobes) refines each lobe column at full resolution, in
    range blocks of the JAX lax.map's size, where a strict > lets the
    earlier lobe win ties. The best is compared with the local winner's
    gain on the same device bank. Returns, in the input's protocol, the
    nominated row where it strictly beats a live local winner, else none."""
    n = cfg.range_size
    mb = lb // n
    dev = raw.device
    n_domains = int(meta[3])
    dc = db // stride
    grblk = _pow2_divisor(mb, cfg.range_block)
    packed = db < PACK3_MAX_ROWS
    rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
    ranges = weighted[:lb].reshape(mb, n)  # the caller buckets nb >= lb
    if packed:
        local_rows = unpack3(local_rows)
    bank = build_bank(rawf * inv, cfg.tile_size, n, cfg.domain_step, db, n_domains)
    # nomination stats on the subsampled rows only (per-row quantities)
    bank_sub = bank.reshape(dc, stride, n)[:, 0, :]
    sub_mean, sub_denom = affine_stats(bank_sub)
    v_sub = torch.arange(dc, device=dev) * stride < n_domains
    r_c = ranges - row_mean(ranges)[:, None]
    lobes = topc_scan(
        r_c, bank_sub.T.contiguous(),
        domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub, topc,
        domain_thresh(sub_denom, cfg.objective, cfg.s_clip), cfg.s_clip,
    )
    best_i = torch.zeros(mb, dtype=torch.int32, device=dev)
    best_s = torch.full((mb,), float("-inf"), device=dev)
    for r0 in range(0, mb, grblk):
        rb = ranges[r0 : r0 + grblk]
        bi, bs = best_i[r0 : r0 + grblk], best_s[r0 : r0 + grblk]
        for c in range(topc):
            i_c, s_c = refine_from_lobes(
                rb, bank, n_domains, lobes[r0 : r0 + grblk, c : c + 1], stride,
                cfg.s_clip, cfg.objective,
            )
            take = s_c > bs  # strict: the earlier lobe wins ties
            bs.copy_(torch.where(take, s_c, bs))
            bi.copy_(torch.where(take, i_c, bi))
    # the local winner's gain on the SAME device bank: one float32 metric
    # on both sides of the comparison
    live = local_rows >= 0
    ls, _ = _window_gains(
        r_c.T, bank, local_rows.clamp(0, db - 1).to(torch.int64)[None, :],
        live[None, :], cfg.objective, cfg.s_clip,
    )
    win = torch.isfinite(best_s) & (best_s > ls[0]) & live
    if packed:
        return pack3(torch.where(win, best_i, IDX3_SENTINEL).to(torch.int32))
    return torch.where(win, best_i, -1).to(torch.int32)


def _empty_result(cfg: EncoderConfig, original_len: int):
    return (
        np.empty(0, dtype=MATCH_DTYPE),
        np.zeros((0, cfg.range_size), dtype=np.float32),
        0,
        cfg.range_size,
        cfg.tile_size,
        cfg.domain_step,
        cfg.energy_thresh,
        original_len,
    )


def _as_i16_or_f32(signal: np.ndarray):
    """16-bit-exact content ships to the device as int16 (half the bytes);
    the device casts it back to float32 exactly. Returns (src, in_i16)."""
    peak = float(np.max(np.abs(signal))) if len(signal) else 0.0
    if np.isfinite(peak) and peak <= 32767.0:
        as_i16 = signal.astype(np.int16)
        if np.array_equal(signal, as_i16):
            return as_i16, True
    return signal, False


def _prep_signal(signal: np.ndarray, cfg: EncoderConfig):
    """Counts and shape buckets (the JAX package's, so both take the same
    search branch), and the padded raw buffer. Returns (raw_p, n_ranges,
    n_domains, lb, db), or None when the signal has no ranges or no
    domains. Raises ValueError past the 3-byte code's 2^24 rows."""
    range_size = cfg.range_size
    original_len = len(signal)
    n_ranges = -(-original_len // range_size) if original_len else 0
    n_domains = n_domains_for(original_len, cfg.tile_size, cfg.domain_step)
    if n_ranges == 0 or n_domains == 0:
        return None
    if n_domains >= 1 << 24:
        raise ValueError(
            f"{n_domains} domains exceeds the single-shot encoder's 2^24 "
            "index range; encode long files with "
            "models.stream.compress_audio_streaming"
        )
    nb = bucket(original_len, 4096)
    lb = bucket(n_ranges, 256) * range_size
    db = bucket(n_domains, 256)
    src, in_i16 = _as_i16_or_f32(signal)
    raw_p = np.zeros(nb, dtype=np.int16 if in_i16 else np.float32)
    raw_p[:original_len] = src
    return raw_p, n_ranges, n_domains, lb, db


def _compress_fast(signal: np.ndarray, cfg: EncoderConfig, device: torch.device):
    """Single-shot encode: device core, idx-only transfer, host refit. The
    host bank is built while the device runs (kernel launches return at
    once); the copy of the codes waits for the device."""
    original_len = len(signal)
    prep = _prep_signal(signal, cfg)
    if prep is None:
        return _empty_result(cfg, original_len)
    raw_p, n_ranges, n_domains, lb, db = prep
    search_mode, stride = _plan_search(cfg, lb // cfg.range_size, db)
    raw = torch.from_numpy(raw_p).to(device)
    codes = encode_core(
        raw, original_len, n_ranges, n_domains, lb, db, cfg, search_mode, stride
    )
    bank = build_domains_host(signal, cfg.tile_size, cfg.range_size, cfg.domain_step)
    c = codes.cpu().numpy()[:n_ranges]
    assert len(bank) == n_domains
    return _finalize_encode(c, signal, cfg, n_ranges, original_len, bank)


def _finalize_encode(c, signal, cfg, n_ranges, original_len, bank):
    """Host half of the idx-only protocol: sentinel classification and the
    exact refit of the device's selections against the serialized bank
    (copied from the JAX package)."""
    range_size = cfg.range_size
    pad_len = (range_size - (original_len % range_size)) % range_size
    if cfg.fast_mode and bool(np.all(c == 0xFF)):  # every code 0xFFFFFF
        # all pruned: an all-silent file gives the empty container
        voiced = voiced_detection(
            signal, frame_size=range_size * 2, energy_threshold=cfg.energy_thresh,
        )
        if float(np.sum((signal * voiced).astype(np.float64) ** 2)) < 1e-8:
            return _empty_result(cfg, original_len)
        ranges_host = None
    elif cfg.fast_mode:
        # every live range is fully voiced, so the raw ranges are its refit
        # targets (the reflected tail's sources are voiced whenever the
        # tail is live)
        padded = np.pad(signal, (0, pad_len), mode="reflect") if pad_len else signal
        ranges_host = padded.reshape(n_ranges, range_size)
    else:
        voiced = voiced_detection(
            signal, frame_size=range_size * 2, energy_threshold=cfg.energy_thresh,
        )
        weighted = signal * voiced
        if float(np.sum(weighted.astype(np.float64) ** 2)) < 1e-8:
            return _empty_result(cfg, original_len)
        if pad_len:
            weighted = np.pad(weighted, (0, pad_len), mode="reflect")
        ranges_host = weighted.reshape(n_ranges, range_size)

    rec = collect_idx_matches(c, n_ranges, ranges_host, bank, cfg.s_clip)
    return (
        rec, bank, n_ranges, range_size, cfg.tile_size, cfg.domain_step,
        cfg.energy_thresh, original_len,
    )


def collect_idx_matches(codes, n_ranges: int, ranges, bank, s_clip: float):
    """3-byte codes -> MATCH_DTYPE records: sentinels become
    (-1, 1, 0, 0, 0); live rows are refit on the host (refit_host, or the
    native kernel that runs the same rule)."""
    b3 = np.ascontiguousarray(codes[:n_ranges])
    if ranges is not None:
        from ..io import native

        rec = native.collect(
            b3, np.ascontiguousarray(ranges, dtype=np.float32), bank, s_clip
        )
        if rec is not None:
            return rec

    c = unpack3_np(b3)
    dead = c < 0
    rec = np.empty(n_ranges, dtype=MATCH_DTYPE)
    if ranges is None or bool(np.all(dead)):
        rec["idx"] = -1
        rec["s"] = 1.0
        rec["o"] = 0.0
        rec["sym"] = 0
        rec["err"] = 0.0
        return rec
    idx = np.where(dead, 0, c).astype(np.int32)
    s, o, err, sym = refit_host(ranges, bank, idx, s_clip)
    rec["idx"] = np.where(dead, -1, idx)
    rec["s"] = np.where(dead, np.float32(1.0), s)
    rec["o"] = np.where(dead, np.float32(0.0), o)
    rec["sym"] = np.where(dead, False, sym).astype(np.uint8)
    rec["err"] = np.where(dead, np.float32(0.0), err)
    return rec


def prune_bank(rec: np.ndarray, bank: np.ndarray):
    """Drop every bank row no match references and reindex. An all-sentinel
    table keeps one zero row, so the file stays loadable. Returns
    (rec', bank'); rec is not modified."""
    used = np.unique(rec["idx"][rec["idx"] >= 0])
    if used.size == 0 and len(bank):
        return rec.copy(), np.zeros((1, bank.shape[1]), dtype=np.float32)
    return remap_matches(rec, used), np.ascontiguousarray(bank[used])


def remap_matches(rec: np.ndarray, used: np.ndarray) -> np.ndarray:
    """Reindex live matches against the sorted kept-row list `used`."""
    out = rec.copy()
    live = out["idx"] >= 0
    out["idx"][live] = np.searchsorted(used, out["idx"][live]).astype(np.int32)
    return out


def compress_audio_arrays(
    signal,
    framerate,
    sampwidth,
    tile_size: int = 1024,
    emb_dim: int = 16,
    top_k: int = 32,
    ef_search: int = 50,
    use_gpu: bool = False,
    energy_thresh: float = 1e-4,
    domains_tmpdir=None,
    batch_size_gpu: int = 512,
    batch_size_cpu: int = 128,
    fast_mode: bool = True,
    transient_weight: float = 1.0,
    n_mels: int = 40,
    cpu_workers=None,
    search: str = "auto",
    objective: str = "balanced",
    global_candidates: bool | None = None,
    config: EncoderConfig | None = None,
    device="cuda",
):
    """Encode one mono signal; returns (records, bank, n_ranges,
    range_size, tile_size, domain_step, energy_thresh, original_len) with
    MATCH_DTYPE records. `device` runs the core: "cuda" (the default) or,
    when asked for, "cpu", which runs the kernels' plain versions.

    The keyword set is the JAX package's: `emb_dim`, `top_k` and
    `global_candidates` ride the config (a single-shot encode searches the
    whole bank, so the last changes nothing here; file-level callers pass
    one set to this and to the streaming encoder); the other
    reference-signature kwargs are accepted and do nothing."""
    del framerate, sampwidth  # not used by the encode; kept for API symmetry
    del ef_search, use_gpu, domains_tmpdir, batch_size_gpu, batch_size_cpu
    del transient_weight, n_mels, cpu_workers
    dev = resolve_device(device)
    cfg = config or EncoderConfig(
        tile_size=tile_size, emb_dim=emb_dim, top_k=top_k,
        energy_thresh=energy_thresh, fast_mode=fast_mode, search=search,
        objective=objective, global_candidates=global_candidates,
    )
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    return _compress_fast(signal, cfg, dev)


def compress_audio(signal, framerate, sampwidth, **kwargs):
    """Reference-shaped encode: matches as a list of 5-tuples."""
    from ..io.container import struct_to_matches

    rec, *rest = compress_audio_arrays(signal, framerate, sampwidth, **kwargs)
    return (struct_to_matches(rec), *rest)
