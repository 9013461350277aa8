"""Per-domain selection weights, the selection gain and the staged window
refine: the torch counterparts of fwav_tpu/ops/search.py's
`domain_weights`, `domain_thresh`, `_gain_from_num`, `_window_gains`,
`refine_from_lobes` (its non-sharded form) and, by name, `gain_topk_scan`.
The scans themselves are the kernels in ops/kernels.py; the staged refine
has no kernel behind it in the JAX package either (jnp gathers), so torch
ops are its port."""

from __future__ import annotations

import torch

from .affine import row_mean, row_sum
from .kernels import topc_scan_ref

_EPS = 1e-12
_NEG = float("-inf")


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


def gain_topk_scan(r_c, bank_sub, d_weight, d_valid, top_c: int, domain_block: int = 512,
                   d_thresh=None, s_clip=None):
    """Top-C gain candidates per range over a (subsampled) bank, under the
    JAX package's name and argument order: r_c (M, N) centered ranges,
    bank_sub (Dc, N), d_weight and d_valid (Dc,). The plain version of K3
    (`topc_scan_ref`), whose order it specifies: score descending, the
    lower index first on ties. Returns idx (M, C) int32, -1 where fewer
    than C domains have a finite score. On the card the encode runs K3
    instead (ops/kernels.py topc_scan)."""
    return topc_scan_ref(r_c, bank_sub.T.contiguous(), d_weight, d_valid, top_c,
                         d_thresh, 0.0 if s_clip is None else s_clip,
                         domain_block=domain_block)


def _window_gains(r_c, bank, cand, valid, objective: str, s_clip):
    """Gains and orientation pick of per-range candidate rows. r_c (N, M)
    centered ranges, transposed; bank (D, N); cand (K, M) int64 rows in
    [0, D); valid (K, M). Returns (score, use_m), each (K, M), score -inf
    where not valid. The sums over N run left to right in the (N, K, M)
    layout of the JAX function."""
    N = r_c.shape[0]
    K, M = cand.shape
    tiles = bank.index_select(0, cand.reshape(-1)).T.reshape(N, K, M)

    def over_n(x):  # (N, K, M) -> (K, M), left to right
        return row_sum(x.movedim(0, -1))

    d_mean = row_mean(tiles.movedim(0, -1))
    d_c = tiles - d_mean[None]
    denom = over_n(d_c * d_c) + _EPS
    num_o = over_n(d_c * r_c[:, None, :])
    num_m = over_n(d_c * r_c.flip(0)[:, None, :])
    if objective == "balanced":
        w = (denom - _EPS - N * d_mean * d_mean) / (denom * denom)
    else:
        w = torch.reciprocal(denom)
    thresh = domain_thresh(denom - _EPS, objective, s_clip)
    score_o = _gain_from_num(num_o, w, thresh, s_clip)
    score_m = _gain_from_num(num_m, w, thresh, s_clip)
    use_m = score_m > score_o  # strict: the original orientation wins ties
    score = torch.where(use_m, score_m, score_o)
    return torch.where(valid, score, _NEG), use_m


def refine_from_lobes(ranges, bank, n_valid: int, coarse, stride: int,
                      s_clip: float, objective: str = "balanced"):
    """The window refine around coarse lobes, staged: ranges (M, N); bank
    (D, N), the full bank with its rows from n_valid on invalid; coarse
    (M, C) lobes in the stride-subsampled index space, -1 for none.

    The window of each lobe is W = stride + stride/4 rows starting at
    lobe*stride - W/2, clamped to [0, n_valid - W]. With one lobe column
    and stride >= 32 (the global pass always) the window is sampled at
    step 16 and then 4 (8 alone for W < 64), each stage keeping the first
    best sample, and only a dense window of step + 2 rows around the last
    one is scored in full; otherwise all C*W rows are. Rows at or past
    n_valid never win: padding rows score exactly 0, which beats a
    negative balanced gain. Returns (idx (M,) int32, score (M,) float32)
    of the first best candidate; the score is -inf where the range has no
    lobe. The JAX function's refit outputs (s, o, sym, err) are not
    ported: only the selection leaves the device and the host refits it."""
    M, N = ranges.shape
    D = bank.shape[0]
    dev = ranges.device
    top_c = coarse.shape[1]
    W = max(2, stride + stride // 4)
    last = max(n_valid - 1, 0)
    lobe_ok = coarse >= 0                                        # (M, C)
    starts = (coarse.to(torch.int64) * stride - W // 2).clamp(0, max(n_valid - W, 0))
    cand = (starts.T[:, None, :]
            + torch.arange(W, device=dev)[None, :, None]).reshape(top_c * W, M)
    valid = lobe_ok.T[:, None, :].expand(top_c, W, M).reshape(top_c * W, M)
    r_c = (ranges - row_mean(ranges)[:, None]).T                 # (N, M)
    cols = torch.arange(M, device=dev)

    if stride >= 32 and top_c == 1:
        steps = (16, 4) if W >= 64 else (8,)
        st = steps[0]
        k1 = W // st + 1
        mid = (starts.T[:, None, :]
               + (st * torch.arange(k1, device=dev))[None, :, None]
               ).reshape(top_c * k1, M).clamp(max=last)
        v1 = lobe_ok.T[:, None, :].expand(top_c, k1, M).reshape(top_c * k1, M)
        v1 = v1 & (mid < n_valid)
        s1, _ = _window_gains(r_c, bank, mid.clamp(max=D - 1), v1, objective, s_clip)
        center = mid[s1.argmax(0), cols]                         # first max
        ok_any = lobe_ok.any(1)
        for st2 in steps[1:]:
            # cover center +/- st/2 at the finer step st2
            u = st // 2
            k = 2 * u // st2 + 1
            mid = ((center[None, :] - u)
                   + st2 * torch.arange(k, device=dev)[:, None]).clamp(0, last)
            vk = ok_any[None, :].expand(k, M) & (mid < n_valid)
            sk, _ = _window_gains(r_c, bank, mid.clamp(max=D - 1), vk, objective, s_clip)
            center = mid[sk.argmax(0), cols]
            st = st2
        # the dense final window: +/- st/2, with one row of margin
        w2 = st + 2
        starts2 = (center - w2 // 2).clamp(0, max(n_valid - w2, 0))
        cand = starts2[None, :] + torch.arange(w2, device=dev)[:, None]
        valid = ok_any[None, :].expand(w2, M)

    valid = valid & (cand < n_valid)
    cand = cand.clamp(max=D - 1)  # jnp.take's clamp, explicit here
    score, _ = _window_gains(r_c, bank, cand, valid, objective, s_clip)
    pick = score.argmax(0)                                       # first max
    return cand[pick, cols].to(torch.int32), score[pick, cols]
