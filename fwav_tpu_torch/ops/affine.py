"""Affine statistics, the shortlist solve and the host refit.

`affine_stats`, `batched_affine_match`, `affine_match_tiles`,
`find_best_domain_affine` and `affine_solve_single` are the torch
counterparts of fwav_tpu/ops/affine.py's; the row reductions here are
left-to-right sums, so a CPU and a CUDA run give the same bits.
`refit_host` and `_TIE_TOL` are copied from that module (numpy, host
side): the stored s, o, err and orientation come from it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

_EPS = 1e-12
#: Orientation tie tolerance, relative to the Cauchy-Schwarz bound
#: sqrt(sum r_c^2)*sqrt(sum t_c^2) on |num|. Must exceed n*ulp_f32 so the
#: numpy and native refits, which accumulate in different orders, agree on
#: every mathematically tied orientation. Keep in sync with TIE_TOL in
#: fwav_tpu/native/fwavio.cpp.
_TIE_TOL = 1e-5


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """`row_sum` divided by the row length. The divisor is a tensor on the
    data's device: PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead, which is not exact for every length. It is
    filled on the device: torch.tensor(..., device="cuda") copies from the
    host and waits for the stream, which stalls the launch queue."""
    n = torch.full((), float(x.shape[-1]), dtype=x.dtype, device=x.device)
    return row_sum(x) / n


def affine_stats(tiles: torch.Tensor):
    """Per-tile mean and centered energy over the last axis."""
    mean = row_mean(tiles)
    centered = tiles - mean[..., None]
    return mean, row_sum(centered * centered)


def batched_affine_match(ranges, cand_idx, bank, s_clip: float = 16.0,
                         objective: str = "affine", return_score: bool = False):
    """The best (domain, orientation) of each range among its candidates:
    ranges (B, N), cand_idx (B, K) int, -1 for an empty slot, bank (D, N).
    The slots are gathered (an empty one clamped to row 0 and masked) and
    solved by affine_match_tiles. Returns (idx, s, o, sym, err), each (B,);
    err is +inf where every slot is empty. With return_score the winner's
    selection score (minimized, +inf where every slot is empty) and its
    position among the originals-then-mirrors (sym * K + slot) follow."""
    safe = cand_idx.clamp(min=0).to(torch.int64)
    tiles = bank[safe]                                        # (B, K, N)
    return affine_match_tiles(ranges, tiles, safe, cand_idx < 0, s_clip=s_clip,
                              objective=objective, return_score=return_score)


def affine_match_tiles(ranges, tiles, cand_idx, invalid, s_clip: float = 16.0,
                       objective: str = "affine", selection_precision=None,
                       return_score: bool = False):
    """batched_affine_match for callers that hold the tiles: tiles (B, K,
    N), cand_idx (B, K) the row of each tile, invalid (B, K). The K
    originals come first and then the K mirrors, and the first minimum
    wins, so ties go to the original orientation and the earlier slot.
    "affine" selects by the affine error, "balanced" adds the default
    decoder's offset penalty N (s d_mean)^2, "damped" takes the error of the
    clipped scale; err is computed with the unclipped s and s is clipped
    after the pick. The winner is refit on its own tile, so the returned
    s, o and err are exact for the chosen pair. `selection_precision` is
    accepted for the JAX package's signature: the sums here are float32."""
    del selection_precision
    B, N = ranges.shape
    K = cand_idx.shape[1]
    d_mean, d_denom = affine_stats(tiles)                     # (B, K)
    r_mean = row_mean(ranges)[:, None]                        # (B, 1)
    r_c = ranges - r_mean
    r_e = row_sum(r_c * r_c)[:, None]
    num_o = row_sum(tiles * r_c[:, None, :])
    num_m = row_sum(tiles * r_c.flip(-1)[:, None, :])
    num = torch.cat([num_o, num_m], dim=1)                    # originals first
    denom = torch.cat([d_denom, d_denom], dim=1) + _EPS
    mean2 = torch.cat([d_mean, d_mean], dim=1)
    s = num / denom
    err2 = r_e - 2.0 * s * num + s * s * (denom - _EPS)
    err = torch.sqrt(err2.clamp(min=0.0))
    if objective == "balanced":
        score = err2 + N * (s * mean2) ** 2
    elif objective == "damped":
        s_cl = s.clamp(-abs(s_clip), abs(s_clip))
        score = r_e - 2.0 * s_cl * num + s_cl * s_cl * (denom - _EPS)
    else:
        score = err
    invalid2 = torch.cat([invalid, invalid], dim=1)
    err = err.masked_fill(invalid2, float("inf"))
    score = score.masked_fill(invalid2, float("inf"))
    pick = torch.argmin(score, dim=1)                         # first minimum
    rows = torch.arange(B, device=ranges.device)
    best_idx = torch.cat([cand_idx, cand_idx], dim=1)[rows, pick]
    best_sym = (pick >= K).to(torch.uint8)
    # the exact refit of the winning tile
    tile = tiles[rows, torch.where(pick >= K, pick - K, pick)]   # (B, N)
    tile = torch.where(best_sym[:, None].bool(), tile.flip(-1), tile)
    t_mean = row_mean(tile)
    t_c = tile - t_mean[:, None]
    t_denom = row_sum(t_c * t_c)
    best_s = row_sum(r_c * t_c) / (t_denom + _EPS)
    best_o = r_mean[:, 0] - best_s * t_mean
    resid = r_c - best_s[:, None] * t_c
    best_err = torch.sqrt(row_sum(resid * resid))
    best_err = torch.where(torch.isinf(err[rows, pick]), float("inf"), best_err)
    best_s = best_s.clamp(-abs(s_clip), abs(s_clip))
    out = (best_idx.to(torch.int32), best_s, best_o, best_sym, best_err)
    if return_score:
        out = (*out, score[rows, pick], pick.to(torch.int32))
    return out


def find_best_domain_affine(range_block, domains, candidate_idxs, range_size=None,
                            use_gpu: bool = False, s_clip: float = 16.0,
                            device="cuda"):
    """Reference-shaped single-range candidate solve on `device`:
    `domains` is a (D, N) array or the path of a float32 domain memmap;
    returns (best_idx, s, o, sym, err) as Python numbers, with (-1, 0, 0,
    0, inf) for no candidate. `use_gpu` is accepted for the reference's
    signature: `device` decides."""
    del use_gpu
    dev = resolve_device(device)
    if isinstance(domains, (str, bytes)) or hasattr(domains, "__fspath__"):
        import os

        if range_size is None:
            range_size = len(np.asarray(range_block).reshape(-1))
        size = os.path.getsize(domains)
        row = 4 * int(range_size)
        if size % row:
            raise ValueError(
                f"domain memmap size {size} is not a multiple of the "
                f"{row}-byte row (range_size={range_size})"
            )
        domains = np.memmap(
            domains, dtype="float32", mode="r", shape=(size // row, int(range_size))
        )
    bank = np.asarray(domains, dtype=np.float32)
    cand = np.asarray(
        [int(c) for c in (candidate_idxs if candidate_idxs is not None else []) if int(c) >= 0],
        dtype=np.int64,
    )
    if cand.size == 0:
        return -1, 0.0, 0.0, 0, float("inf")
    idx, s, o, sym, err = batched_affine_match(
        torch.as_tensor(np.asarray(range_block, dtype=np.float32), device=dev)[None, :],
        torch.from_numpy(cand).to(dev)[None, :], torch.tensor(bank, device=dev),
        s_clip=s_clip,
    )
    return int(idx[0]), float(s[0]), float(o[0]), int(sym[0]), float(err[0])


def affine_solve_single(range_block, tile, device="cuda"):
    """(s, o, sym, err) of one range against one tile, both orientations
    considered: 0-d tensors on `device`."""
    dev = resolve_device(device)
    r = torch.as_tensor(range_block, dtype=torch.float32, device=dev)
    t = torch.as_tensor(tile, dtype=torch.float32, device=dev)
    _, s, o, sym, err = batched_affine_match(
        r[None, :], torch.zeros((1, 1), dtype=torch.int64, device=r.device), t[None, :])
    return s[0], o[0], sym[0], err[0]


def refit_host(ranges, bank, idx, s_clip: float = 16.0):
    """Exact float32 affine refit of selected domain rows, on the host,
    against the serialized bank (copied from fwav_tpu/ops/affine.py). The
    orientation is re-derived here: the mirror wins only by more than
    `_TIE_TOL` of the Cauchy-Schwarz bound. s = num/(denom + 1e-12),
    o = mean(r) - s*mean(d), err from the unclipped s, then s is clipped to
    +/- s_clip. ranges (M, N) float32; idx (M,) int32 of valid rows.
    Returns (s, o, err, sym). The native kernel in fwavio.cpp runs the same
    rule; this numpy path is its fallback."""
    r = np.ascontiguousarray(ranges, dtype=np.float32)
    from ..io import native

    out = native.refit(r, bank, idx, s_clip)
    if out is not None:
        return out
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
    rcss = np.einsum("ij,ij->i", r_c, r_c)
    tol = np.float32(_TIE_TOL) * np.sqrt(rcss) * np.sqrt(denom)
    sym = np.abs(num_m) > np.abs(num_o) + tol
    num = np.where(sym, num_m, num_o)
    s = num / (denom + np.float32(_EPS))
    o = r_mean - s * t_mean
    r_c_eff = np.where(sym[:, None], r_c[:, ::-1], r_c)
    resid = r_c_eff - s[:, None] * t_c
    err = np.sqrt(np.einsum("ij,ij->i", resid, resid))
    s = np.clip(s, -abs(s_clip), abs(s_clip))
    return s, o, err, sym
