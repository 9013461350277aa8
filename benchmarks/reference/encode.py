"""The plain reference encoder of one file: what the codec must produce.

A frozen, standalone copy of the codec's plain path (the arithmetic that
its CUDA kernels are specified by), reduced to one file at a time: the
bucket counts, the normalization and the device VAD, the ranges with the
reflect-padded tail, the search plan ("exact", or "coarse" with the
window refine or the staged refine), the coarse scan (one lobe or the top
C), the refine around the lobes, the sentinel rule, the host bank and the
host refit. Plain PyTorch and NumPy; it imports nothing of the program.
Every float32 reduction is written as explicit adds in a fixed order, so
that it gives the same bits on the card and on the CPU.

`lowp=True` is the control: the same arithmetic with every stage's inputs
(the normalized signal, the bank and box means, the refit's ranges and
rows) rounded to bfloat16, as a scan that multiplies on the tensor cores
in one BF16 product instead of an exact split would see them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EPS = 1e-12
NEG = float("-inf")
#: The refit's orientation tie tolerance, relative to the Cauchy-Schwarz
#: bound on |num|: the mirror wins only by more than this.
TIE_TOL = 1e-5
OBJECTIVES = ("balanced", "affine", "damped")


@dataclasses.dataclass(frozen=True)
class Settings:
    """The encoder settings a configuration file states (its "encoder")."""

    tile_size: int = 1024
    energy_thresh: float = 1e-4
    search: str = "auto"
    objective: str = "balanced"
    fast_mode: bool = True
    s_clip: float = 16.0
    auto_coarse_threshold: int = 32768
    coarse_stride: int = 128
    coarse_topc: int = 1
    domain_block: int = 2048
    range_block: int = 32768

    @property
    def range_size(self) -> int:
        return max(4, self.tile_size // 256)

    @property
    def domain_step(self) -> int:
        return max(1, self.range_size // 4)

    @property
    def topc(self) -> int:
        """Coarse lobes per range: the damped objective takes at least 4."""
        return max(self.coarse_topc, 4) if self.objective == "damped" else self.coarse_topc


@dataclasses.dataclass
class Encoded:
    """The reference's answer for one file."""

    n_ranges: int
    original_len: int
    live: np.ndarray        # (n_ranges,) bool: not a sentinel
    idx: np.ndarray         # (n_ranges,) int64 bank row, -1 where dead
    ranges: np.ndarray      # (n_ranges, n) float32 refit targets (raw, tail reflected)
    bank: np.ndarray        # (n_domains, n) float32 host bank
    s: np.ndarray
    o: np.ndarray
    sym: np.ndarray


# --- counts and plan ----------------------------------------------------------


def bucket(n: int, minimum: int = 256) -> int:
    """Smallest value >= max(n, 1) from {4, 5, 6, 7} * (minimum/4) * 2^k."""
    if n <= minimum:
        return minimum
    b = minimum
    while True:
        for num in (5, 6, 7):
            c = (b // 4) * num
            if c >= n:
                return c
        b *= 2
        if b >= n:
            return b


def n_domains_for(n_samples: int, tile_size: int, domain_step: int) -> int:
    if n_samples < tile_size:
        return 0
    return (n_samples - tile_size) // domain_step + 1


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class Plan:
    """Counts, buckets and search plan of one file."""

    n_samples: int
    n_ranges: int
    n_domains: int
    nb: int
    mb: int
    db: int
    mode: str      # "exact" or "coarse"
    stride: int
    refine: str | None  # None, "window" or "staged"
    topc: int


def plan_at(cfg: Settings, mb: int, db: int) -> Plan:
    """The search plan at mb bucketed ranges and a db-row bucketed bank:
    the same gates (a stride that is a multiple of 128, domain_step 1,
    whole range blocks, a box-mean sequence within 9 MB) decide between
    the window refine and the staged one. The counts are left 0."""
    n = cfg.range_size
    if cfg.objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {cfg.objective!r}")
    block_len = cfg.tile_size // n
    stride = min(cfg.coarse_stride, max(1, block_len // 2))
    stride = 1 << (stride.bit_length() - 1)
    mode = cfg.search
    if mode == "auto":
        mode = "coarse" if db >= max(cfg.auto_coarse_threshold, 256 * stride) and stride > 1 \
            else "exact"
    if mode == "exact":
        return Plan(0, 0, 0, 0, mb, db, "exact", stride, None, 1)
    if mode != "coarse":
        raise ValueError(f"no reference for search mode {mode!r}")
    rblk = _pow2_divisor(mb, cfg.range_block)
    window = (cfg.domain_step == 1 and stride % 128 == 0 and mb % rblk == 0
              and rblk % 8 == 0 and db * 4 <= 9 << 20)
    if cfg.topc == 1:
        prb = 512 if rblk % 512 == 0 else _pow2_divisor(rblk, 512)
        dc = db // stride
        dblk = _pow2_divisor(dc, cfg.domain_block)
        window = window and (dblk % 128 == 0 or dblk == dc) and (prb % 8 == 0 or prb == rblk)
    return Plan(0, 0, 0, 0, mb, db, "coarse", stride, "window" if window else "staged",
                cfg.topc)


def plan(cfg: Settings, n_samples: int) -> Plan:
    """The counts, buckets and search plan the codec takes for one file
    encoded in one piece."""
    n = cfg.range_size
    n_ranges = -(-n_samples // n)
    n_domains = n_domains_for(n_samples, cfg.tile_size, cfg.domain_step)
    if n_ranges == 0 or n_domains == 0:
        raise ValueError("a file shorter than one tile has no bank")
    p = plan_at(cfg, bucket(n_ranges, 256), bucket(n_domains, 256))
    return dataclasses.replace(p, n_samples=n_samples, n_ranges=n_ranges,
                               n_domains=n_domains, nb=bucket(n_samples, 4096))


# --- plain float32 pieces (torch) ---------------------------------------------------


def _bf16(x, lowp: bool):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def row_sum(x):
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def row_mean(x):
    return row_sum(x) / torch.full((), float(x.shape[-1]), dtype=x.dtype, device=x.device)


def _f32(x: float, like):
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=like.device)


def box_sums(x, width: int):
    """s[p] = sum(x[p : p + width]), two-stage shifted adds (width = b1*b2 + rem)."""
    if width == 1:
        return x
    b1 = max(1, math.isqrt(width))
    b2 = width // b1
    s1 = x
    for t in range(1, b1):
        s1 = s1 + torch.roll(x, -t, dims=-1)
    out = s1
    for k in range(1, b2):
        out = out + torch.roll(s1, -k * b1, dims=-1)
    for t in range(b1 * b2, width):
        out = out + torch.roll(x, -t, dims=-1)
    return out


def voiced_mask(sig, n: int, frame_size: int, thresh: float, smooth_window: int = 5):
    """Per-sample voiced mask of a bucket-padded float32 signal of true
    length n: frame energies over reflect-padded frames, 5-tap smoothing as
    shifted adds, hysteresis (on above thresh, off below thresh / 2)."""
    dev = sig.device
    nb = sig.shape[0]
    n_frames = -(-n // frame_size)
    nfb = nb // frame_size

    def reflected(pos):
        return sig[torch.where(pos < n, pos, 2 * n - 2 - pos).clamp(0, nb - 1)]

    if nb % frame_size == 0:
        framed = sig.reshape(nfb, frame_size)
        e = row_mean(framed * framed)
        tf = n_frames - 1
        tw = reflected(tf * frame_size + torch.arange(frame_size, device=dev))
        e = torch.where(torch.arange(nfb, device=dev) == tf, row_mean(tw * tw), e)
    else:
        framed = reflected(torch.arange(nfb * frame_size, device=dev)).reshape(nfb, frame_size)
        e = row_mean(framed * framed)
    fvalid = torch.arange(nfb, device=dev) < n_frames
    e = torch.where(fvalid, e, 0.0)
    half = smooth_window // 2
    k = 1.0 / smooth_window
    ext = torch.cat([e.new_zeros(half), e, e.new_zeros(half)])
    sm = ext[0:nfb] * k
    for i in range(1, smooth_window):
        sm = sm + ext[i : i + nfb] * k
    e = torch.where(fvalid, sm, 0.0)
    on = e > _f32(thresh, e)
    off = (e < _f32(thresh * 0.5, e)) & ~on
    event = torch.where(on, 1, torch.where(off, -1, 0)).to(torch.int8)
    pos = torch.arange(nfb, dtype=torch.int64, device=dev)
    last = torch.cummax(torch.where(event != 0, pos, -1), dim=0).values
    state = ((last >= 0) & (event[last.clamp(min=0)] > 0)).to(torch.uint8)
    mask = state.repeat_interleave(frame_size)
    if mask.shape[0] < nb:
        mask = torch.cat([mask, mask.new_zeros(nb - mask.shape[0])])
    return torch.where(torch.arange(nb, device=dev) < n, mask, 0).to(torch.uint8)


def build_bank(sig_norm, cfg: Settings, db: int, n_domains: int):
    """(db, n) device bank of the normalized padded signal, rows from
    n_domains on zero."""
    n = cfg.range_size
    block_len = cfg.tile_size // n
    step = cfg.domain_step
    nb = sig_norm.shape[0]
    means = box_sums(sig_norm, block_len) * (1.0 / block_len)
    need = (n - 1) * block_len + (db - 1) * step + 1
    if need > nb:
        means = torch.cat([means, means.new_zeros(need - nb)])
    span = (db - 1) * step + 1
    bank = torch.stack([means[j * block_len : j * block_len + span : step] for j in range(n)],
                       dim=-1)
    rows = torch.arange(db, device=bank.device)
    return torch.where((rows < n_domains)[:, None], bank, 0.0)


def _means_setup(sig_norm, n: int, block_len: int, stride: int, dc: int):
    """The box-mean sequence with a stride-wide zero lead (what the window
    refine reads) and the stride-subsampled bank rows (strided views)."""
    means = box_sums(sig_norm, block_len) * (1.0 / block_len)
    W = stride + stride // 4
    ls = stride - W // 2 + (W - 1) + (n - 1) * block_len + 1
    Lext = -(-(stride + (dc - 1) * stride + -(-ls // 128) * 128) // 128) * 128
    k = min(means.shape[0], Lext - stride)
    means_ext = torch.cat([means.new_zeros(stride), means[:k], means.new_zeros(Lext - stride - k)])
    span = (dc - 1) * stride + 1
    mp = means if means.shape[0] >= span + (n - 1) * block_len else means_ext[stride:]
    bank_sub = torch.stack([mp[j * block_len : j * block_len + span : stride] for j in range(n)],
                           dim=-1)
    return means_ext, bank_sub


def affine_stats(tiles):
    mean = row_mean(tiles)
    c = tiles - mean[..., None]
    return mean, row_sum(c * c)


def domain_weights(d_mean, d_denom, n: int, objective: str):
    denom_eps = d_denom + EPS
    if objective == "balanced":
        return (d_denom - n * d_mean * d_mean) / (denom_eps * denom_eps)
    return torch.reciprocal(denom_eps)


def domain_thresh(d_denom, objective: str, s_clip: float):
    return abs(s_clip) * d_denom if objective == "damped" else None


def _fill_nums(r, b, no, nm, t):
    N = r.shape[1]
    torch.mul(r[:, 0:1], b[0], out=no)
    torch.mul(r[:, N - 1 : N], b[0], out=nm)
    for j in range(1, N):
        no.add_(torch.mul(r[:, j : j + 1], b[j], out=t))
        nm.add_(torch.mul(r[:, N - 1 - j : N - j], b[j], out=t))


def _block_gains(r, b, wk, tk, c, bufs, fold_first: bool):
    """Gains (rb, db) of a block of pairs, written into bufs[2] (t)."""
    no, nm, t, a = bufs
    _fill_nums(r, b, no, nm, t)
    if tk is not None and fold_first:
        # damped top-C: the orientations fold before the clip branch
        torch.maximum(no.abs_(), nm.abs_(), out=a)
        clip = a > tk
        torch.mul(a, a, out=t).mul_(wk)
        a.mul_(2.0).sub_(tk).mul_(c)
        torch.where(clip, a, t, out=t)
        return t
    for num in (no, nm):
        if tk is not None:
            torch.abs(num, out=a)
            clip = a > tk
            a.mul_(2.0).sub_(tk).mul_(c)
        num.mul_(num).mul_(wk)
        if tk is not None:
            torch.where(clip, a, num, out=num)
    torch.maximum(no, nm, out=t)
    return t


#: Ranges and domains per block of the scans, by device: every result is
#: the same whatever the blocks (first maxima, stable top-C lists); on the
#: card large blocks keep the launches few.
SCAN_BLOCKS = {"cpu": (2048, 512), "cuda": (16384, 4096)}


def _blocks(t) -> tuple[int, int]:
    return SCAN_BLOCKS.get(t.device.type, SCAN_BLOCKS["cpu"])


def search_scan(r_c, bankT, w, valid, thresh, s_clip):
    """Per range the lowest-index maximum over valid domains of the
    orientation-folded gain: (score (M,), idx (M,))."""
    M, N = r_c.shape
    D = bankT.shape[1]
    dev = r_c.device
    range_block, domain_block = _blocks(r_c)
    c = abs(float(s_clip))
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int64, device=dev)
    shape = (min(range_block, M), min(domain_block, D))
    bufs_all = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(4)]
    for r0 in range(0, M, range_block):
        r = r_c[r0 : r0 + range_block]
        rb = r.shape[0]
        best = torch.full((rb,), NEG, dtype=torch.float32, device=dev)
        best_i = torch.zeros(rb, dtype=torch.int64, device=dev)
        for d0 in range(0, D, domain_block):
            b = bankT[:, d0 : d0 + domain_block]
            nd = b.shape[1]
            bufs = [x[:rb, :nd] for x in bufs_all]
            t = _block_gains(r, b, w[d0 : d0 + nd], None if thresh is None
                             else thresh[d0 : d0 + nd], c, bufs, fold_first=False)
            t.masked_fill_(valid[d0 : d0 + nd] == 0, NEG)
            arg = torch.argmax(t, dim=1)
            g = t.gather(1, arg[:, None])[:, 0]
            upd = g > best
            best = torch.where(upd, g, best)
            best_i = torch.where(upd, arg + d0, best_i)
        score[r0 : r0 + rb] = best
        idx[r0 : r0 + rb] = best_i
    return score, idx


def topc_scan(r_c, bankT, w, valid, top_c: int, thresh, s_clip):
    """Per range the top_c domains by gain, in the stable order (score
    descending, lower index first): (M, top_c) int64, -1 where not finite."""
    M, N = r_c.shape
    D = bankT.shape[1]
    dev = r_c.device
    range_block, domain_block = _blocks(r_c)
    c = abs(float(s_clip))
    out = torch.empty((top_c, M), dtype=torch.int64, device=dev)
    shape = (min(range_block, M), min(domain_block, D))
    bufs_all = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(4)]
    for r0 in range(0, M, range_block):
        r = r_c[r0 : r0 + range_block]
        rb = r.shape[0]
        best_s = [torch.full((rb,), NEG, dtype=torch.float32, device=dev) for _ in range(top_c)]
        best_i = [torch.zeros(rb, dtype=torch.int64, device=dev) for _ in range(top_c)]
        for d0 in range(0, D, domain_block):
            b = bankT[:, d0 : d0 + domain_block]
            nd = b.shape[1]
            bufs = [x[:rb, :nd] for x in bufs_all]
            t = _block_gains(r, b, w[d0 : d0 + nd], None if thresh is None
                             else thresh[d0 : d0 + nd], c, bufs, fold_first=True)
            t.masked_fill_(valid[d0 : d0 + nd] == 0, NEG)
            for _ in range(top_c):
                arg = torch.argmax(t, dim=1)[:, None]
                cur_s = t.gather(1, arg)[:, 0]
                cur_i = arg[:, 0] + d0
                t.scatter_(1, arg, NEG)
                moving = torch.zeros(rb, dtype=torch.bool, device=dev)
                for k in range(top_c):
                    take = moving | (cur_s > best_s[k])
                    best_s[k], cur_s = (torch.where(take, cur_s, best_s[k]),
                                        torch.where(take, best_s[k], cur_s))
                    best_i[k], cur_i = (torch.where(take, cur_i, best_i[k]),
                                        torch.where(take, best_i[k], cur_i))
                    moving = take
        for k in range(top_c):
            out[k, r0 : r0 + rb] = torch.where(torch.isfinite(best_s[k]), best_i[k], -1)
    return out.T


def _window_taps(means_ext, q, n: int, block_len: int):
    L = means_ext.shape[0]
    return [torch.where(q + j * block_len < L, means_ext[(q + j * block_len).clamp(max=L - 1)],
                        0.0) for j in range(n)]


def _position_stats(v, n: int):
    mean = v[0]
    for vj in v[1:]:
        mean = mean + vj
    mean = mean * (1.0 / n)
    denom = torch.zeros_like(mean)
    for vj in v:
        d = vj - mean
        denom = denom + d * d
    return mean, denom, denom + 1e-12


def _refine_one_lobe(means_ext, lobes, ranges, n_valid: int, stride: int, block_len: int,
                     objective: str, s_clip: float, range_block: int = 16384):
    M, n = ranges.shape
    dev = ranges.device
    W = stride + stride // 4
    half = W // 2
    c = abs(float(s_clip))
    t = torch.arange(W, device=dev)
    last = max(n_valid - 1, 0)
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int64, device=dev)
    for r0 in range(0, M, range_block):
        lob = lobes[r0 : r0 + range_block]
        r = ranges[r0 : r0 + range_block]
        rc = r - row_mean(r)[:, None]
        p0 = lob.clamp(min=0) * stride - half
        v = _window_taps(means_ext, (p0 + stride)[:, None] + t[None, :], n, block_len)
        mean, denom, denom_eps = _position_stats(v, n)
        no = rc[:, 0:1] * v[0]
        nm = rc[:, n - 1 : n] * v[0]
        for j in range(1, n):
            no = no + rc[:, j : j + 1] * v[j]
            nm = nm + rc[:, n - 1 - j : n - j] * v[j]
        if objective == "balanced":
            wgt = (denom - n * mean * mean) / (denom_eps * denom_eps)
            sc = torch.maximum(no * no, nm * nm) * wgt
        elif objective == "damped":
            a = torch.maximum(no.abs(), nm.abs())
            th = c * denom
            sc = torch.where(a > th, c * (2.0 * a - th), a * a / denom_eps)
        else:
            sc = torch.maximum(no * no, nm * nm) / denom_eps
        pos = p0[:, None] + t[None, :]
        sc = torch.where((pos >= 0) & (pos < n_valid) & (lob[:, None] >= 0), sc, NEG)
        arg = torch.argmax(sc, dim=1)
        score[r0 : r0 + range_block] = sc.gather(1, arg[:, None])[:, 0]
        idx[r0 : r0 + range_block] = torch.clamp((p0 + arg).clamp(min=0), max=last)
    return score, idx


def refine_window(means_ext, lobes, ranges, n_valid: int, stride: int, block_len: int,
                  objective: str, s_clip: float):
    """The dense window refine around every lobe column; a later column
    takes a range only with a strictly higher score."""
    best = None
    for col in lobes.unbind(1):
        s_k, i_k = _refine_one_lobe(means_ext, col, ranges, n_valid, stride, block_len,
                                    objective, s_clip)
        if best is None:
            best = (s_k, i_k)
        else:
            take = s_k > best[0]
            best = (torch.where(take, s_k, best[0]), torch.where(take, i_k, best[1]))
    return best


def _gain_from_num(num, weight, thresh, s_clip):
    g = num * num * weight
    if thresh is None:
        return g
    a = torch.abs(num)
    return torch.where(a > thresh, abs(s_clip) * (2.0 * a - thresh), g)


def _window_gains(r_c, bank, cand, valid, objective: str, s_clip):
    """Gains of per-range candidate rows: r_c (N, M), cand (K, M)."""
    N = r_c.shape[0]
    K, M = cand.shape
    tiles = bank.index_select(0, cand.reshape(-1)).T.reshape(N, K, M)

    def over_n(x):
        return row_sum(x.movedim(0, -1))

    d_mean = row_mean(tiles.movedim(0, -1))
    d_c = tiles - d_mean[None]
    denom = over_n(d_c * d_c) + EPS
    num_o = over_n(d_c * r_c[:, None, :])
    num_m = over_n(d_c * r_c.flip(0)[:, None, :])
    if objective == "balanced":
        w = (denom - EPS - N * d_mean * d_mean) / (denom * denom)
    else:
        w = torch.reciprocal(denom)
    thresh = domain_thresh(denom - EPS, objective, s_clip)
    so = _gain_from_num(num_o, w, thresh, s_clip)
    sm = _gain_from_num(num_m, w, thresh, s_clip)
    return torch.where(valid, torch.where(sm > so, sm, so), NEG)


def staged_refine(ranges, bank, n_valid: int, coarse, stride: int, objective: str,
                  s_clip: float, range_block: int = 32768):
    """The staged window refine around coarse lobes over the full bank:
    one lobe column at stride >= 32 descends (samples at step 16, then 4,
    then a dense window of step + 2 rows), else all C*W rows are scored."""
    idx_out, score_out = [], []
    for r0 in range(0, ranges.shape[0], range_block):
        i, s = _staged_block(ranges[r0 : r0 + range_block], bank, n_valid,
                             coarse[r0 : r0 + range_block], stride, objective, s_clip)
        idx_out.append(i)
        score_out.append(s)
    return torch.cat(idx_out), torch.cat(score_out)


def _staged_block(ranges, bank, n_valid: int, coarse, stride, objective, s_clip):
    M, N = ranges.shape
    D = bank.shape[0]
    dev = ranges.device
    top_c = coarse.shape[1]
    W = max(2, stride + stride // 4)
    last = max(n_valid - 1, 0)
    lobe_ok = coarse >= 0
    starts = torch.clamp((coarse * stride - W // 2).clamp(min=0), max=max(n_valid - W, 0))
    cand = (starts.T[:, None, :] + torch.arange(W, device=dev)[None, :, None]
            ).reshape(top_c * W, M)
    valid = lobe_ok.T[:, None, :].expand(top_c, W, M).reshape(top_c * W, M)
    r_c = (ranges - row_mean(ranges)[:, None]).T
    cols = torch.arange(M, device=dev)
    if stride >= 32 and top_c == 1:
        steps = (16, 4) if W >= 64 else (8,)
        st = steps[0]
        k1 = W // st + 1
        mid = torch.clamp(starts.T[:, None, :] + (st * torch.arange(k1, device=dev))[None, :, None],
                          max=last).reshape(top_c * k1, M)
        v1 = lobe_ok.T[:, None, :].expand(top_c, k1, M).reshape(top_c * k1, M) & (mid < n_valid)
        s1 = _window_gains(r_c, bank, mid.clamp(max=D - 1), v1, objective, s_clip)
        center = mid[s1.argmax(0), cols]
        ok_any = lobe_ok.any(1)
        for st2 in steps[1:]:
            u = st // 2
            k = 2 * u // st2 + 1
            mid = torch.clamp(((center[None, :] - u)
                               + st2 * torch.arange(k, device=dev)[:, None]).clamp(min=0), max=last)
            vk = ok_any[None, :].expand(k, M) & (mid < n_valid)
            sk = _window_gains(r_c, bank, mid.clamp(max=D - 1), vk, objective, s_clip)
            center = mid[sk.argmax(0), cols]
            st = st2
        w2 = st + 2
        starts2 = torch.clamp((center - w2 // 2).clamp(min=0), max=max(n_valid - w2, 0))
        cand = starts2[None, :] + torch.arange(w2, device=dev)[:, None]
        valid = ok_any[None, :].expand(w2, M)
    valid = valid & (cand < n_valid)
    cand = cand.clamp(max=D - 1)
    score = _window_gains(r_c, bank, cand, valid, objective, s_clip)
    pick = score.argmax(0)
    return cand[pick, cols], score[pick, cols]


# --- the device half ------------------------------------------------------------


def device_half(signal: np.ndarray, cfg: Settings, p: Plan, device, lowp: bool = False):
    """(live (n_ranges,), idx (n_ranges,)) of one file encoded in one
    piece: what the codec's device program selects."""
    n = cfg.range_size
    ns, nb, mb = p.n_samples, p.nb, p.mb
    raw = torch.zeros(nb, dtype=torch.float32, device=device)
    raw[:ns] = torch.from_numpy(np.ascontiguousarray(signal, dtype=np.float32)).to(device)
    scale = raw.abs().amax()
    inv = torch.where(scale > 0, torch.reciprocal(scale), 1.0)
    # the VAD reads the raw samples; the ranges and the bank the normalized
    mask = voiced_mask(_bf16(raw, lowp), ns, 2 * n, float(cfg.energy_thresh))
    sig_norm = _bf16(raw * inv, lowp)
    weighted = sig_norm * mask.to(torch.float32)
    lb = mb * n
    base = weighted[:lb] if lb <= nb else torch.cat([weighted, weighted.new_zeros(lb - nb)])
    ranges = base.reshape(mb, n).clone()
    last = (ns - 1) // n
    if ns % n:
        tpos = last * n + torch.arange(n, device=device)
        ranges[last] = weighted[torch.where(tpos < ns, tpos, 2 * ns - 2 - tpos).clamp(0, nb - 1)]
    return search_with_plan(cfg, p, ranges, sig_norm, inv, device, lowp)


def search_with_plan(cfg: Settings, p: Plan, ranges, sig_norm, inv, device, lowp: bool):
    """(live (n_ranges,), idx (n_ranges,)) of the ranges (mb, n) of one
    program (one file, or one shard of a stream): the search of its plan
    over the bank of the normalized signal sig_norm, then the sentinel
    rule (silent, padding, or no finite score)."""
    n = cfg.range_size
    mb, db = p.mb, p.db
    r_c = ranges - row_mean(ranges)[:, None]
    if p.mode == "exact":
        bank = _bf16(build_bank(sig_norm, cfg, db, p.n_domains), lowp)
        d_mean, d_denom = affine_stats(bank)
        valid = torch.arange(db, device=device) < p.n_domains
        score, idx = search_scan(r_c, bank.T.contiguous(),
                                 domain_weights(d_mean, d_denom, n, cfg.objective), valid,
                                 domain_thresh(d_denom, cfg.objective, cfg.s_clip), cfg.s_clip)
    else:
        dc = db // p.stride
        block_len = cfg.tile_size // n
        if p.refine == "window":
            means_ext, bank_sub = _means_setup(sig_norm, n, block_len, p.stride, dc)
            means_ext, bank_sub = _bf16(means_ext, lowp), _bf16(bank_sub, lowp)
        else:
            bank = _bf16(build_bank(sig_norm, cfg, db, p.n_domains), lowp)
            bank_sub = bank.reshape(dc, p.stride, n)[:, 0, :]
        sub_mean, sub_denom = affine_stats(bank_sub)
        v_sub = torch.arange(dc, device=device) * p.stride < p.n_domains
        args = (r_c, bank_sub.T.contiguous(),
                domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub)
        thresh = domain_thresh(sub_denom, cfg.objective, cfg.s_clip)
        if p.topc == 1:
            score, cidx = search_scan(*args, thresh, cfg.s_clip)
            lobes = torch.where(torch.isfinite(score), cidx, -1)[:, None]
        else:
            lobes = topc_scan(*args, p.topc, thresh, cfg.s_clip)
        if p.refine == "window":
            score, idx = refine_window(means_ext, lobes, ranges, p.n_domains, p.stride,
                                       block_len, cfg.objective, cfg.s_clip)
        else:
            idx, score = staged_refine(ranges, bank, p.n_domains, lobes, p.stride,
                                       cfg.objective, cfg.s_clip)
    r_pow = row_mean(ranges * ranges)
    thr_n = float(cfg.energy_thresh) * inv * inv
    r_valid = torch.arange(mb, device=device) < p.n_ranges
    silent = (r_pow < thr_n * 0.75) if cfg.fast_mode else torch.zeros_like(r_valid)
    dead = silent | ~r_valid | ~torch.isfinite(score)
    live = (~dead)[: p.n_ranges].cpu().numpy()
    idx = torch.where(dead, -1, idx)[: p.n_ranges].cpu().numpy().astype(np.int64)
    return live, idx


# --- the host half (numpy) ---------------------------------------------------------


def _bf16_np(x: np.ndarray, lowp: bool) -> np.ndarray:
    if not lowp:
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).to(
        torch.float32).numpy()


def host_bank(signal: np.ndarray, cfg: Settings) -> np.ndarray:
    """The serialized bank: block means of every tile_size window at
    domain_step, from float64 cumulative sums."""
    n = cfg.range_size
    step = cfg.domain_step
    d = n_domains_for(len(signal), cfg.tile_size, step)
    block_len = cfg.tile_size // n
    cs = np.zeros(len(signal) + 1, dtype=np.float64)
    np.cumsum(np.asarray(signal, np.float32), dtype=np.float64, out=cs[1:])
    out = np.empty((d, n), dtype=np.float32)
    for j in range(n):
        lo = j * block_len
        a = cs[lo + block_len : lo + block_len + d * step : step]
        b = cs[lo : lo + d * step : step]
        np.multiply(a - b, 1.0 / block_len, out=out[:, j], casting="unsafe")
    return out


def refit(ranges: np.ndarray, bank: np.ndarray, idx: np.ndarray, s_clip: float):
    """Float32 affine refit of the selected rows: the mirror only by more
    than TIE_TOL of the Cauchy-Schwarz bound; s = num / (denom + eps) clipped
    to +/- s_clip, o = mean(r) - s mean(t). Returns (s, o, sym)."""
    r = np.ascontiguousarray(ranges, dtype=np.float32)
    n = r.shape[1]
    q = np.full((n, 1), np.float32(1.0 / n))
    t = np.take(np.asarray(bank, dtype=np.float32), idx, axis=0)
    r_mean = np.matmul(r, q)[:, 0]
    t_mean = np.matmul(t, q)[:, 0]
    r_c = r - r_mean[:, None]
    t_c = t - t_mean[:, None]
    num_o = np.einsum("ij,ij->i", r_c, t_c)
    num_m = np.einsum("ij,ij->i", r_c[:, ::-1], t_c)
    denom = np.einsum("ij,ij->i", t_c, t_c)
    tol = np.float32(TIE_TOL) * np.sqrt(np.einsum("ij,ij->i", r_c, r_c)) * np.sqrt(denom)
    sym = np.abs(num_m) > np.abs(num_o) + tol
    s = np.where(sym, num_m, num_o) / (denom + np.float32(EPS))
    o = r_mean - s * t_mean
    return np.clip(s, -abs(s_clip), abs(s_clip)), o, sym


def host_ranges(signal: np.ndarray, n: int) -> np.ndarray:
    """The refit targets: the raw samples in ranges, the tail reflected."""
    pad = (n - len(signal) % n) % n
    x = np.pad(signal, (0, pad), mode="reflect") if pad else signal
    return np.ascontiguousarray(x, dtype=np.float32).reshape(-1, n)


def encode(signal: np.ndarray, cfg: Settings, device="cpu", lowp: bool = False) -> Encoded:
    """The reference's answer for one mono signal (int16 sample values as
    float32)."""
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    p = plan(cfg, len(signal))
    live, idx = device_half(signal, cfg, p, device, lowp)
    bank = _bf16_np(host_bank(signal, cfg), lowp)
    ranges = host_ranges(signal, cfg.range_size)
    s = np.ones(p.n_ranges, np.float32)
    o = np.zeros(p.n_ranges, np.float32)
    sym = np.zeros(p.n_ranges, bool)
    if live.any():
        s_l, o_l, sym_l = refit(_bf16_np(ranges[live], lowp), bank, idx[live], cfg.s_clip)
        s[live], o[live], sym[live] = s_l, o_l, sym_l
    return Encoded(p.n_ranges, len(signal), live, idx, ranges, bank, s, o, sym)
