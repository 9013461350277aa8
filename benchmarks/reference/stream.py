"""The plain reference of the codec's streaming encode (files over 2^22
samples): what it must produce for one long file.

A frozen copy of the streaming path's semantics over the plain pieces of
reference/encode.py: the VAD once over the whole file on the host, time
shards of 2^20 samples whose ranges search the windows that start within
a halo of 2^18 samples around them (one shape bucket for every shard, the
window's own normalization, the host VAD's mask), the host refit of each
shard's selections against whole-file rows, and, for the damped
objective, the whole-file global-candidate pass: the top 4 rows of the
stride-512 subsampled bank nominated for every range, each nominee's
column refined alone at full resolution (the staged refine), and the best
taken only where it strictly beats the shard's winner on the same device
bank. Plain PyTorch and NumPy; it imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encode import (
    NEG,
    Encoded,
    Plan,
    Settings,
    _bf16,
    _bf16_np,
    _window_gains,
    affine_stats,
    bucket,
    build_bank,
    domain_thresh,
    domain_weights,
    host_bank,
    n_domains_for,
    plan_at,
    refit,
    row_mean,
    search_with_plan,
    staged_refine,
    topc_scan,
)

#: Files longer than this (samples) take the streaming encode.
STREAMING_THRESHOLD = 1 << 22
SHARD = 1 << 20
HALO = 1 << 18
GLOBAL_STRIDE = 512
GLOBAL_TOPC = 4
GLOBAL_NOM_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The shards' common buckets and plan."""

    bounds: list
    geo: list       # per shard (g0, ranges, window rows, window length, range offset)
    nbw: int
    plan: Plan      # the shards' search plan at (mb, db)


def voiced_host(signal: np.ndarray, frame_size: int, thresh: float, smooth: int = 5):
    """Per-sample 0/1 voiced mask (host): frame energies over the
    reflect-padded frames, a 5-tap moving mean, hysteresis from t = 0 (on
    above thresh, off below thresh / 2)."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    n_frames = -(-n // frame_size)
    pad = n_frames * frame_size - n
    frames = (np.pad(signal, (0, pad), mode="reflect") if pad else signal).reshape(
        n_frames, frame_size)
    e = np.mean(frames * frames, axis=1)
    e = np.convolve(e, np.ones(smooth, dtype=np.float32) / smooth, mode="same")
    on = e > thresh
    off = e < thresh * 0.5
    event = np.where(on, 1, np.where(off & ~on, -1, 0)).astype(np.int8)
    marked = np.where(event != 0, np.arange(n_frames), -1)
    last = np.maximum.accumulate(marked)
    state = np.where(last >= 0, event[np.clip(last, 0, None)] > 0, False).astype(np.uint8)
    return np.repeat(state, frame_size)[:n]


def stream_plan(cfg: Settings, n_samples: int, shard: int = SHARD,
                halo: int = HALO) -> StreamPlan:
    n, step, tile = cfg.range_size, cfg.domain_step, cfg.tile_size
    L = n_samples + (n - n_samples % n) % n
    shard = max(n, (shard // n) * n)
    bounds = [(a, min(L, a + shard)) for a in range(0, L, shard)]
    geo = []
    for a, b in bounds:
        g0 = (max(0, a - halo) // step) * step
        g1, g1p = min(n_samples, b + halo), min(L, b + halo)
        geo.append((g0, (b - a) // n, n_domains_for(g1 - g0, tile, step), g1p - g0, a - g0))
    live = [g for g in geo if g[2] > 0]
    mb = bucket(max(g[1] for g in live), 256)
    db = bucket(max(g[2] for g in live), 256)
    nbw = bucket(max(max(g[3] for g in live), max(g[4] for g in live) + mb * n), 4096)
    return StreamPlan(bounds, geo, nbw, plan_at(cfg, mb, db))


def _shard(cfg, sp: StreamPlan, signal_p, voiced_p, k, device, lowp):
    """(live, window-local rows) of shard k's ranges: the masked program."""
    n = cfg.range_size
    g0, m, n_dom, lenw, off = sp.geo[k]
    p = sp.plan
    nb = sp.nbw
    raw = torch.zeros(nb, dtype=torch.float32, device=device)
    raw[:lenw] = torch.from_numpy(np.ascontiguousarray(signal_p[g0 : g0 + lenw])).to(device)
    mask = torch.zeros(nb, dtype=torch.float32, device=device)
    mask[:lenw] = torch.from_numpy(voiced_p[g0 : g0 + lenw].astype(np.float32)).to(device)
    scale = raw.abs().amax()
    inv = torch.where(scale > 0, torch.reciprocal(scale), 1.0)
    weighted = _bf16(raw * (mask * inv), lowp)
    sig_norm = _bf16(raw * inv, lowp)
    lb = p.mb * n
    o = min(max(off, 0), nb - lb)
    ranges = weighted[o : o + lb].reshape(p.mb, n)
    shard_plan = dataclasses.replace(p, n_ranges=m, n_domains=n_dom)
    return search_with_plan(cfg, shard_plan, ranges, sig_norm, inv, device, lowp)


def global_stride(d_total: int, stride: int = GLOBAL_STRIDE) -> int:
    """The pass's nomination stride: doubled until the grid fits."""
    while -(-d_total // stride) > GLOBAL_NOM_ROWS:
        stride *= 2
    return stride


def _global(cfg, rec_idx, signal_p, voiced_p, n_samples, device, lowp, stride):
    """The global pass's winners: a whole-file row per range, -1 where the
    shard's winner stands."""
    n, step, tile = cfg.range_size, cfg.domain_step, cfg.tile_size
    d_total = n_domains_for(n_samples, tile, step)
    if d_total <= 2 * stride:
        return np.full(len(rec_idx), -1)
    stride = global_stride(d_total, stride)
    L = len(signal_p)
    m = L // n
    lb = bucket(m, 256) * n
    dc = bucket(-(-d_total // stride), 16)
    db = dc * stride
    nb = bucket(max(L, lb), 4096)
    raw = torch.zeros(nb, dtype=torch.float32, device=device)
    raw[:L] = torch.from_numpy(np.ascontiguousarray(signal_p)).to(device)
    mask = torch.zeros(nb, dtype=torch.float32, device=device)
    mask[:L] = torch.from_numpy(voiced_p.astype(np.float32)).to(device)
    scale = raw.abs().amax()
    inv = torch.where(scale > 0, torch.reciprocal(scale), 1.0)
    ranges = _bf16(raw * (mask * inv), lowp)[:lb].reshape(lb // n, n)
    bank = _bf16(build_bank(raw * inv, cfg, db, d_total), lowp)
    bank_sub = bank.reshape(dc, stride, n)[:, 0, :]
    sub_mean, sub_denom = affine_stats(bank_sub)
    v_sub = torch.arange(dc, device=device) * stride < d_total
    r_c = ranges - row_mean(ranges)[:, None]
    lobes = topc_scan(r_c, bank_sub.T.contiguous(),
                      domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub, GLOBAL_TOPC,
                      domain_thresh(sub_denom, cfg.objective, cfg.s_clip), cfg.s_clip)
    best_i = torch.zeros(lb // n, dtype=torch.int64, device=device)
    best_s = torch.full((lb // n,), NEG, dtype=torch.float32, device=device)
    for c in range(GLOBAL_TOPC):
        i_c, s_c = staged_refine(ranges, bank, d_total, lobes[:, c : c + 1], stride,
                                 cfg.objective, cfg.s_clip)
        take = s_c > best_s
        best_s, best_i = torch.where(take, s_c, best_s), torch.where(take, i_c, best_i)
    local = torch.full((lb // n,), -1, dtype=torch.int64, device=device)
    local[:m] = torch.from_numpy(rec_idx).to(device)
    live = local >= 0
    ls = _window_gains(r_c.T, bank, local.clamp(0, db - 1)[None, :], live[None, :],
                       cfg.objective, cfg.s_clip)[0]
    win = torch.isfinite(best_s) & (best_s > ls) & live
    return torch.where(win, best_i, -1)[:m].cpu().numpy()


def encode_stream(signal: np.ndarray, cfg: Settings, device="cpu", lowp: bool = False,
                  shard: int = SHARD, halo: int = HALO, stride: int = GLOBAL_STRIDE) -> Encoded:
    """The reference's answer for one long mono signal (int16 sample values
    as float32). The pass runs for the damped objective over more than one
    shard."""
    n, step = cfg.range_size, cfg.domain_step
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    N = len(signal)
    voiced = voiced_host(signal, 2 * n, cfg.energy_thresh)
    pad = (n - N % n) % n
    signal_p = np.pad(signal, (0, pad), mode="reflect") if pad else signal
    voiced_p = np.pad(voiced, (0, pad), mode="reflect") if pad else voiced
    weighted = signal * voiced
    weighted = np.pad(weighted, (0, pad), mode="reflect") if pad else weighted
    sp = stream_plan(cfg, N, shard, halo)
    live_parts, idx_parts = [], []
    for k, (a, b) in enumerate(sp.bounds):
        g0, m, n_dom, _, _ = sp.geo[k]
        if n_dom == 0:
            live_parts.append(np.zeros(m, bool))
            idx_parts.append(np.full(m, -1, np.int64))
            continue
        live, idx = _shard(cfg, sp, signal_p, voiced_p, k, device, lowp)
        live_parts.append(live)
        idx_parts.append(np.where(live, idx + g0 // step, -1))
    live = np.concatenate(live_parts)
    idx = np.concatenate(idx_parts)
    if cfg.objective == "damped" and len(sp.bounds) > 1 and live.any():
        win = _global(cfg, idx, signal_p, voiced_p, N, device, lowp, stride)
        idx = np.where(win >= 0, win, idx)
    bank = _bf16_np(host_bank(signal, cfg), lowp)
    ranges = np.ascontiguousarray(weighted, np.float32).reshape(-1, n)
    s = np.ones(len(live), np.float32)
    o = np.zeros(len(live), np.float32)
    sym = np.zeros(len(live), bool)
    if live.any():
        s[live], o[live], sym[live] = refit(_bf16_np(ranges[live], lowp), bank, idx[live],
                                            cfg.s_clip)
    return Encoded(len(live), N, live, idx, ranges, bank, s, o, sym)
