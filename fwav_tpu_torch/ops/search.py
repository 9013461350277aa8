"""Per-domain selection weights and the selection gain, the torch
counterparts of fwav_tpu/ops/search.py's `domain_weights`, `domain_thresh`
and `_gain_from_num`. The searches themselves are the kernels in
ops/kernels.py."""

from __future__ import annotations

import torch

_EPS = 1e-12


def domain_weights(d_mean, d_denom, n: int, objective: str):
    """Per-domain weight w such that the best pair maximizes num^2 * w.
    "balanced" adds the s_damping=0 decoder's offset penalty
    N*(s*d_mean)^2 to the affine residual; "affine" and "damped" weigh by
    1/denom (the damped clip branch rides `domain_thresh`)."""
    denom_eps = d_denom + _EPS
    if objective == "balanced":
        return (d_denom - n * d_mean * d_mean) / (denom_eps * denom_eps)
    return torch.reciprocal(denom_eps)


def domain_thresh(d_denom, objective: str, s_clip: float):
    """Per-domain clip threshold t = s_clip * denom for "damped" (None for
    every other objective): the optimal scale num/denom clips exactly when
    |num| > t."""
    if objective != "damped":
        return None
    return abs(s_clip) * d_denom


def _gain_from_num(num, weight, thresh, s_clip):
    """Selection gain of one orientation: num^2 * w, or with `thresh` the
    clip-aware gain, c*(2|num| - t) where |num| > t (c = s_clip)."""
    g = num * num * weight
    if thresh is None:
        return g
    a = torch.abs(num)
    c = abs(s_clip)
    return torch.where(a > thresh, c * (2.0 * a - thresh), g)
