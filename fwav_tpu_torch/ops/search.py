"""Per-domain selection weights, the selection gain, the staged window
refine and the embedding shortlist: the torch counterparts of
fwav_tpu/ops/search.py's `domain_weights`, `domain_thresh`,
`_gain_from_num`, `_window_gains`, `refine_from_lobes` (its non-sharded
form), `coarse_refine_search`, `exact_search_block`, `merge_shard_bests`,
the topk search (`_topk_merge_scan`, `topk_scores_block`,
`topk_search_block`), the reference-shaped candidate
helpers and, by name, `gain_topk_scan`. The scans themselves are the
kernels in ops/kernels.py. The staged refine has no Pallas kernel behind
it (jnp ops, which XLA fuses): `refine_from_lobes` is the plain version of
the kernel that takes that fusion's place on the card, K4, so it lives
beside the other plain versions in ops/kernels.py with `_window_gains`,
`_gain_from_num` and `domain_thresh`, and is exported here under the JAX
names. The topk search is torch ops, as it is jnp ops in the JAX package.

The topk merge keeps the JAX order exactly: a shortlist is the top k by
(score descending, domain index ascending), which is what lax.top_k's
stable ties and the carried-entries-first merge give. torch.topk promises
no order among ties, so `_stable_topk` takes a stable sort instead.
"""

from __future__ import annotations

import numpy as np
import torch

from .affine import affine_stats, batched_affine_match, row_mean, row_sum
from .dct import ieee_fp32_matmul, multi_head_embedding_batch
from .kernels import (  # noqa: F401  (_gain_from_num, refine_from_lobes: the JAX names)
    _gain_from_num,
    _window_gains,
    domain_thresh,
    refine_from_lobes,
    search_scan,
    staged_refine,
    topc_scan_ref,
)

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


def exact_search_block(ranges, bank, d_mean, d_denom, d_valid, domain_block: int,
                       s_clip: float, objective: str = "balanced",
                       return_score: bool = False):
    """The best (domain, orientation) of every range of the block against
    the whole bank: K1 (ops/kernels.py search_scan, its plain version on
    the CPU) picks the domain, then the winner is refit on its tile.
    Returns (idx, s, o, sym, err), each (M,), err +inf where no domain is
    valid; with return_score the scan's score follows. K1 reports no
    orientation, so the winner's is taken again from its two gains (the
    mirror only where it scores strictly more). `domain_block` is accepted
    for the JAX package's signature: the kernel picks its own blocks."""
    del domain_block
    n = ranges.shape[1]
    r_c = ranges - row_mean(ranges)[:, None]
    score, idx = search_scan(
        r_c, bank.T.contiguous(), domain_weights(d_mean, d_denom, n, objective),
        d_valid, domain_thresh(d_denom, objective, s_clip), s_clip,
    )
    out = _refit_winners(ranges, bank, idx, score, s_clip, objective)
    return (*out, score) if return_score else out


def _refit_winners(ranges, bank, idx, score, s_clip: float, objective: str):
    """(idx, s, o, sym, err) of each range's selected bank row: the
    orientation taken again from the row's two gains (the mirror only where
    it scores strictly more), then the affine fit on the oriented tile; err
    +inf where the score is not finite."""
    r_mean = row_mean(ranges)
    r_c = ranges - r_mean[:, None]
    rows = idx.to(torch.int64)
    _, use_m = _window_gains(r_c.T, bank, rows[None, :],
                             torch.ones_like(rows, dtype=torch.bool)[None, :], objective,
                             s_clip)
    sym = use_m[0]
    tile = bank[rows]
    tile = torch.where(sym[:, None], tile.flip(-1), tile)
    t_mean = row_mean(tile)
    t_c = tile - t_mean[:, None]
    t_denom = row_sum(t_c * t_c)
    s = row_sum(r_c * t_c) / (t_denom + _EPS)
    o = r_mean - s * t_mean
    resid = r_c - s[:, None] * t_c
    err = torch.sqrt(row_sum(resid * resid))
    err = torch.where(torch.isfinite(score), err, float("inf"))
    return idx, s.clamp(-abs(s_clip), abs(s_clip)), o, sym.to(torch.uint8), err


def coarse_refine_search(ranges, bank, d_mean, d_denom, d_valid, stride: int, top_c: int,
                         domain_block: int, s_clip: float, objective: str = "balanced",
                         return_score: bool = False):
    """Coarse-to-fine search (the JAX package's op, its signature and
    semantics): scan the bank's every stride-th row for the top-C lobes of
    each range (`gain_topk_scan`), then refine the window around them
    (`refine_from_lobes`) and refit the winner. ranges (M, N), bank (D, N)
    the full bank, d_valid (D,) a prefix of valid rows; d_mean and d_denom
    the bank's stats (D,), or None to take them from the subsampled rows
    only. Returns (idx, s, o, sym, err), each (M,), err +inf where a range
    has no candidate; with return_score the selection score follows.
    Torch ops on the inputs' device, as the JAX op is jnp ops, but for the
    refine: K4 on a card, its plain version on the CPU."""
    M, N = ranges.shape
    D = bank.shape[0]
    assert D % stride == 0 and (D // stride) % domain_block == 0
    r_c = ranges - row_mean(ranges)[:, None]
    bank_sub = bank.reshape(D // stride, stride, N)[:, 0, :]
    if d_mean is None:
        # the weights are per row: stats of the subsampled rows equal the
        # full bank's subsampled
        sub_mean, sub_denom = affine_stats(bank_sub)
        weight_sub = domain_weights(sub_mean, sub_denom, N, objective)
        thresh_sub = domain_thresh(sub_denom, objective, s_clip)
    else:
        weight_sub = domain_weights(d_mean, d_denom, N, objective)[::stride]
        thresh = domain_thresh(d_denom, objective, s_clip)
        thresh_sub = None if thresh is None else thresh[::stride]
    coarse = gain_topk_scan(r_c, bank_sub, weight_sub, d_valid[::stride], top_c,
                            domain_block, d_thresh=thresh_sub, s_clip=s_clip)
    n_valid = d_valid.sum().to(torch.int32).reshape(1)
    idx, score = staged_refine(ranges, bank.contiguous(), n_valid, coarse.to(torch.int32),
                               stride, objective, s_clip)
    out = _refit_winners(ranges, bank, idx, score, s_clip, objective)
    return (*out, score) if return_score else out


def merge_shard_bests(score, idx, sym):
    """The per-shard winners of a bank split over tp, stacked on a leading
    shard axis (S, ...), reduced in the single-device tie order: the larger
    score, then the lower global domain row, then the original orientation
    (sym 0) first. Returns the merged (score, idx, sym), each (...). The
    tp branches of the mesh encode (models/encode.py) merge with it on the
    cell that owns the row."""
    best_s, best_i, best_y = score[0], idx[0], sym[0]
    for k in range(1, score.shape[0]):
        s_k, i_k, y_k = score[k], idx[k], sym[k]
        tie = s_k == best_s
        take = (s_k > best_s) | (tie & (i_k < best_i)) | (tie & (i_k == best_i) & ~y_k & best_y)
        best_s = torch.where(take, s_k, best_s)
        best_i = torch.where(take, i_k, best_i)
        best_y = torch.where(take, y_k, best_y)
    return best_s, best_i, best_y


def _stable_topk(score, k: int):
    """The k best entries of each row of score (M, W) by (score
    descending, position ascending), in that order, as lax.top_k returns
    them: a stable descending sort of the row, cut to k. Returns (scores
    (M, k), positions (M, k) int64)."""
    vals, pos = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _topk_merge_scan(score_fn, xs_blocks, M: int, k: int, domain_block: int, n_blocks: int):
    """Blockwise running best-k over domain blocks: score_fn(*block inputs)
    gives an (M, domain_block) score block, -inf at invalid slots. Both of
    the JAX package's merges (k rounds of max-extraction for k <= 8, concat
    and lax.top_k above; carried entries first) keep the top k by (score
    descending, domain index ascending). So does this one: each block's
    stable top k (`_stable_topk`; the whole block when it is narrower than
    k), then a stable sort of the carried k followed by the block's, whose
    indices are all higher. Returns
    (scores (M, k) descending, idx (M, k) int32, -1 where no finite score
    survived)."""
    dev = xs_blocks[0].device
    best_s = torch.full((M, k), _NEG, dtype=torch.float32, device=dev)
    best_i = torch.full((M, k), -1, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        score = score_fn(*(x[b] for x in xs_blocks))
        blk_s, blk_pos = _stable_topk(score, k)
        merged_s = torch.cat([best_s, blk_s], dim=1)
        merged_i = torch.cat([best_i, (blk_pos + b * domain_block).to(torch.int32)], dim=1)
        best_s, order = torch.sort(merged_s, dim=1, descending=True, stable=True)
        best_s, best_i = best_s[:, :k], merged_i.gather(1, order[:, :k])
    return best_s, torch.where(torch.isfinite(best_s), best_i, -1)


def topk_scores_block(q, bank_emb, d_valid, top_k: int, domain_block: int):
    """Blockwise exact top-k by inner product of the query embeddings q
    (M, E) against bank_emb (D, E), d_valid (D,) bool: the on-device
    replacement of the reference's ANN index. The products are float32
    without TF32. Returns (scores (M, k) descending, idx (M, k) int32, -1
    for an empty slot)."""
    M, E = q.shape
    D = bank_emb.shape[0]
    assert D % domain_block == 0
    n_blocks = D // domain_block
    emb_blocks = bank_emb.reshape(n_blocks, domain_block, E)
    valid_blocks = d_valid.reshape(n_blocks, domain_block)

    def score_block(emb_blk, valid_blk):
        with ieee_fp32_matmul():
            scores = q @ emb_blk.T
        return scores.masked_fill(~valid_blk[None, :], _NEG)

    return _topk_merge_scan(score_block, (emb_blocks, valid_blocks), M, top_k,
                            domain_block, n_blocks)


def topk_search_block(ranges, bank, bank_emb, d_valid, top_k: int, domain_block: int,
                      s_clip: float, emb_dim: int = 16, objective: str = "affine",
                      return_score: bool = False):
    """The reference-shaped two-stage search of one block of ranges: the
    ranges' own embeddings, the blockwise top-k shortlist of the bank's,
    then the mirrored affine solve over the shortlist
    (ops/affine.py batched_affine_match; return_score appends the winner's
    selection score and its position)."""
    q = multi_head_embedding_batch(ranges, tonal_k=emb_dim // 2, transient_k=emb_dim // 2)
    _, cand = topk_scores_block(q, bank_emb, d_valid, top_k, domain_block)
    return batched_affine_match(ranges, cand, bank, s_clip=s_clip, objective=objective,
                                return_score=return_score)


def range_candidates_from_embedding(range_block, domain_embs, emb_dim: int = 16,
                                    top_k: int = 32, device="cuda"):
    """Reference-shaped candidate selection that embeds the raw range
    first, on `device` (numpy in, numpy out)."""
    from .dct import multi_head_embedding

    q = multi_head_embedding(
        range_block, tonal_k=emb_dim // 2, transient_k=emb_dim - emb_dim // 2,
        device=device,
    )
    return range_candidates_from_embedding_emb(q, domain_embs, top_k=top_k)


def range_candidates_from_embedding_emb(q, domain_embs, top_k: int = 64):
    """Dense top-k by inner product for one query, in descending score
    order (numpy, host side; copied from the JAX package)."""
    q = np.asarray(q, dtype=np.float32)
    domain_embs = np.asarray(domain_embs, dtype=np.float32)
    scores = domain_embs @ q
    if top_k >= len(scores):
        return np.argsort(scores)[::-1].astype(np.int32)
    idxs = np.argpartition(scores, -top_k)[-top_k:]
    return idxs[np.argsort(scores[idxs])[::-1]].astype(np.int32)


def pad_candidates(idxs, top_k: int):
    """Pad or truncate a candidate list to top_k, -1 filling (copied)."""
    if idxs is None or len(idxs) == 0:
        return np.full(top_k, -1, dtype=np.int32)
    idxs = np.asarray(idxs, dtype=np.int32)
    if len(idxs) >= top_k:
        return idxs[:top_k]
    out = np.full(top_k, -1, dtype=np.int32)
    out[: len(idxs)] = idxs
    return out
