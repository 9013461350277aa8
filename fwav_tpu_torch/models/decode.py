"""Decode: decompress_audio.

The counterpart of fwav_tpu/models/decode.py. At s_damping=0 (with at
least one iteration) the reference decoder's loop reaches its fixed point
at the first iteration, so decode is a host closed form with no device
work: `_decode_fixed_point_np` and `_fixed_point_chunk` are copied from
the JAX package (numpy). Every other setting runs the iterative loop,
`decode_loop`, the torch form of the JAX package's `build_decode_core`,
on the device that was asked for, chunk by chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.container import matches_to_struct
from ..ops.affine import row_mean, row_sum
from ..utils.device import resolve_device

_DENOM_EPS = 1e-12

#: Ranges per decode chunk (closed form and loop): bounds host and device
#: temporaries. Decode is per-range independent; the only coupling is the
#: loop's convergence delta, which becomes per chunk.
DECODE_SHARD_RANGES = 1 << 22


def _decode_fixed_point_np(rec, domains, n_ranges, range_size, s_clip):
    """Host evaluation of the s_damping=0 fixed point, chunked so peak
    temporary memory stays bounded for multi-hour files."""
    out = np.empty(n_ranges * range_size, np.float32)
    for a in range(0, n_ranges, DECODE_SHARD_RANGES):
        b = min(n_ranges, a + DECODE_SHARD_RANGES)
        out[a * range_size : b * range_size] = _fixed_point_chunk(
            rec[a:b], domains, b - a, range_size, s_clip
        )
    return out


def _fixed_point_chunk(rec, domains, n_ranges, range_size, s_clip):
    idx = rec["idx"].astype(np.int64)
    invalid = idx < 0
    safe = np.where(invalid, 0, np.minimum(idx, max(len(domains) - 1, 0)))
    if len(domains):
        tiles = domains[safe].astype(np.float32)
    else:
        tiles = np.zeros((n_ranges, range_size), np.float32)
    tiles[invalid] = 0.0
    sym = np.where(invalid, False, rec["sym"].astype(bool))
    tiles = np.where(sym[:, None], tiles[:, ::-1], tiles)
    s_st = np.where(invalid, 0.0, rec["s"]).astype(np.float32)
    o_st = np.where(invalid, 0.0, rec["o"]).astype(np.float32)

    d_c = tiles - tiles.mean(axis=1, dtype=np.float32)[:, None]
    denom = (d_c * d_c).sum(axis=1, dtype=np.float32)
    valid = denom > _DENOM_EPS
    s_used = np.where(valid, np.float32(0.0), s_st)
    s_used = np.clip(s_used, -abs(s_clip), abs(s_clip)).astype(np.float32)
    return (s_used[:, None] * tiles + o_st[:, None]).reshape(-1)


def decode_loop(idx, s_stored, o_stored, sym, bank, iterations: int,
                convergence_eps: float, s_clip: float, s_damping: float):
    """The iterative reconstruction (fwav_tpu build_decode_core) for one
    chunk, on the device of its tensors: idx (M,) int64 (-1 = sentinel,
    others within the bank), s_stored and o_stored (M,) float32, sym (M,)
    bool, bank (D, N) float32 with D >= 1. Each iteration refits the scale
    against the current reconstruction (blended (1 - d) s_stored + d s_opt
    for s_damping d > 0, else s_opt where the tile has centered energy),
    clips it to +/- s_clip, and stops after `iterations` or once the
    relative delta falls under `convergence_eps`. Returns (recon (M, N)
    float32, iterations run, final delta; inf when none ran).

    The tiles, their centering and denominators do not change between
    iterations and are computed once. The per-range sums are left-to-right
    adds (no matmul, so no TF32); the norms are torch's float32 reductions.
    One .item() per iteration reads the delta for the stop test."""
    invalid = idx < 0
    tiles = bank[torch.where(invalid, 0, idx)]
    tiles = torch.where(invalid[:, None], 0.0, tiles)
    s_st = torch.where(invalid, 0.0, s_stored)
    o_st = torch.where(invalid, 0.0, o_stored)
    symb = sym & ~invalid
    tiles = torch.where(symb[:, None], tiles.flip(1), tiles)
    d_c = tiles - row_mean(tiles)[:, None]
    denom = row_sum(d_c * d_c)
    valid = denom > _DENOM_EPS
    safe_denom = torch.where(valid, denom, 1.0)
    c = abs(float(s_clip))
    eps = float(np.float32(convergence_eps))  # the JAX loop compares in float32

    recon = torch.zeros_like(tiles)
    it, delta = 0, float("inf")
    while it < iterations and delta >= eps:
        r_c = recon - row_mean(recon)[:, None]
        num = row_sum(r_c * d_c)
        s_opt = torch.where(valid, num / safe_denom, 0.0)
        if s_damping > 0:
            s_used = (1.0 - s_damping) * s_st + s_damping * s_opt
        else:
            s_used = torch.where(valid, s_opt, s_st)
        s_used = s_used.clamp(-c, c)
        nxt = s_used[:, None] * tiles + o_st[:, None]
        prev_norm = torch.linalg.vector_norm(recon)
        d = torch.linalg.vector_norm(nxt - recon) / torch.where(
            prev_norm > 0, prev_norm, 1.0
        )
        recon = nxt
        it += 1
        delta = float(d.item())
    return recon, it, delta


def decompress_audio(
    matches,
    domains_array,
    n_ranges,
    range_size,
    iterations: int = 8,
    convergence_eps: float = 1e-3,
    use_gpu: bool = False,
    original_len=None,
    s_clip: float = 16.0,
    s_damping: float = 0.0,
    config=None,
    stats=None,
    device="cuda",
):
    """Reference-shaped decode. `matches` may be a tuple list, a dict of
    arrays or a record array; a DecoderConfig may replace the knobs.
    `stats` (a dict) receives the convergence counters: 'iterations' (of
    the worst chunk), 'final_delta' (its last relative delta) and
    'converged'. The closed form (s_damping=0, iterations >= 1) runs on the
    host and reports the analytic counters: starting from zeros, iteration
    1 lands on the fixed point with delta ||recon||, iteration 2 reproduces
    it with delta 0. Every other setting runs `decode_loop` on `device`:
    "cuda" (the default, the card) or, when asked for, "cpu". `use_gpu` is
    accepted for the reference's signature."""
    del use_gpu
    dev = resolve_device(device)
    if config is not None:
        iterations = config.iterations
        convergence_eps = config.convergence_eps
        s_clip = config.s_clip
        s_damping = config.s_damping
    n_ranges = int(n_ranges)
    range_size = int(range_size)
    if n_ranges == 0:
        _report_convergence(stats, 0, 0.0, convergence_eps)
        return np.zeros(int(original_len or 0), dtype=np.float32)

    rec = matches_to_struct(matches)
    if len(rec) != n_ranges:
        raise ValueError(f"{len(rec)} match records for {n_ranges} ranges")
    domains = np.ascontiguousarray(np.asarray(domains_array, dtype=np.float32))
    if s_damping == 0 and iterations >= 1:
        recon = _decode_fixed_point_np(rec, domains, n_ranges, range_size, s_clip)
        delta1 = float(np.linalg.norm(recon))
        if delta1 < convergence_eps or iterations == 1:
            _report_convergence(stats, 1, delta1, convergence_eps)
        else:
            _report_convergence(stats, 2, 0.0, convergence_eps)
    else:
        recon = _decode_loop_chunks(
            rec, domains, n_ranges, range_size, int(iterations),
            float(convergence_eps), s_clip, float(s_damping), dev, stats,
        )
    if original_len is not None:
        recon = recon[: int(original_len)]
    return recon


def _decode_loop_chunks(rec, domains, n_ranges, range_size, iterations, eps,
                        s_clip, s_damping, dev, stats):
    """`decode_loop` over chunks of DECODE_SHARD_RANGES ranges. The bank
    goes to the device once; a stored idx past the bank is clamped to its
    last row (a corrupt file must not fault the gather), and an empty bank
    becomes one zero row. The JAX package pads each chunk to a shape
    bucket for its compile cache; eager torch compiles nothing per shape,
    and padded rows would add only zeros to every sum, so there is none
    here. The report is the worst chunk's."""
    n_dom = len(domains)
    bank_np = domains if n_dom else np.zeros((1, range_size), np.float32)
    bank = torch.from_numpy(bank_np).to(dev)
    out = np.empty(n_ranges * range_size, np.float32)
    its_max, delta_max = 0, 0.0
    for a in range(0, n_ranges, DECODE_SHARD_RANGES):
        b = min(n_ranges, a + DECODE_SHARD_RANGES)
        r = rec[a:b]
        idx = np.minimum(r["idx"].astype(np.int64), max(n_dom - 1, 0))
        recon, it, delta = decode_loop(
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(np.ascontiguousarray(r["s"])).to(dev),
            torch.from_numpy(np.ascontiguousarray(r["o"])).to(dev),
            torch.from_numpy(r["sym"] != 0).to(dev),
            bank, iterations, eps, s_clip, s_damping,
        )
        out[a * range_size : b * range_size] = recon.cpu().numpy().reshape(-1)
        its_max = max(its_max, it)
        delta_max = max(delta_max, delta)
    _report_convergence(stats, its_max, delta_max, eps)
    return out


def _report_convergence(stats, iterations_run, final_delta, eps):
    if stats is not None:
        stats["iterations"] = int(iterations_run)
        stats["final_delta"] = float(final_delta)
        stats["converged"] = bool(final_delta < eps)
