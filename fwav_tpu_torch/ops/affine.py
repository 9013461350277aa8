"""Affine statistics and the host refit.

`affine_stats` is the torch counterpart of fwav_tpu/ops/affine.py's; the
row reductions here are left-to-right sums, so a CPU and a CUDA run give
the same bits. `refit_host` and `_TIE_TOL` are copied from that module
(numpy, host side): the stored s, o, err and orientation come from it.
"""

from __future__ import annotations

import numpy as np
import torch

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
