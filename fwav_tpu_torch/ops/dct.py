"""Orthonormal DCT-II shape embeddings: the torch counterpart of
fwav_tpu/ops/dct.py.

Every embedding (difference operator, HF weighting, DCT, coefficient
slice, zero-pad) is one precomputed (N, k) linear map (`_tile_embed_map`
and its two siblings, copied from the JAX package: numpy, host side),
applied to a batch of tiles and followed by a masked L2 row-normalize.
Tiles are tiny (range_size 4 to 32), so the map is applied as explicit
sums over N instead of a matmul (pairwise, the order of the JAX package's
CPU dot for N up to 6): float32 throughout, the same bits on the CPU and
the card, and out of reach of TF32 (torch.backends.cuda.matmul.allow_tf32),
as the JAX package's Precision.HIGHEST keeps its products out of bf16
passes. The shortlist's products (ops/search.py) are matmuls, run inside
`ieee_fp32_matmul`.

- tile_embedding: DCT-II ortho, linspace(1, 2) HF weight applied before
  dropping DC, k coefficients from index 1, zero-padded, normalized;
- transient_embedding: first difference with prepend=tile[0], the same
  weight, DCT, the first k coefficients, normalized;
- tonal_embedding: plain DCT, DC dropped, no weighting, not padded;
- multi_head_embedding: the tonal head (tile_embedding) then the transient
  head, zero-padded to tonal_k + transient_k: the 16-D vector of the topk
  search (emb_dim 16 -> 8 + 8).
"""

from __future__ import annotations

import contextlib
import threading
from functools import lru_cache

import numpy as np
import torch

from ..config import EMBED_K
from ..utils.device import resolve_device
from .affine import row_sum

_NORM_EPS = 1e-8  # rows are normalized only when ||e|| > 1e-8


#: Held around every block of `ieee_fp32_matmul`: the TF32 flag is
#: process-wide, and a second thread's block must not restore it under the
#: first one's product.
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def ieee_fp32_matmul():
    """float32 products in full precision inside the block: TF32 off for
    CUDA matmuls (the JAX package's Precision.HIGHEST), restored after.
    Blocks take turns under `_TF32_LOCK`. A matmul of another thread that
    runs meanwhile outside such a block sees TF32 off too, which only
    makes it exact; with PyTorch's default (TF32 off) nothing changes."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


@lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C with (C @ x)[k] == scipy dct(x,
    norm='ortho')[k]: C[k, t] = a_k cos(pi (2t + 1) k / (2n)), a_0 =
    sqrt(1/n), a_k = sqrt(2/n)."""
    t = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    c = np.cos(np.pi * (2.0 * t[None, :] + 1.0) * k / (2.0 * n))
    c *= np.sqrt(2.0 / n)
    c[0, :] *= np.sqrt(0.5)
    return c


@lru_cache(maxsize=None)
def _tile_embed_map(n: int, k: int) -> np.ndarray:
    """(n, k) map for tile_embedding: weighted DCT, drop DC, slice, zero-pad."""
    c = dct2_matrix(n)
    w = np.linspace(1.0, 2.0, n)
    take = min(k, max(0, n - 1))
    m = np.zeros((n, k), dtype=np.float64)
    # column j picks weighted coefficient j+1
    m[:, :take] = (c[1 : 1 + take, :] * w[1 : 1 + take, None]).T
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _transient_embed_map(n: int, k: int) -> np.ndarray:
    """(n, k) map for transient_embedding: diff-with-prepend, weight, DCT,
    first k."""
    c = dct2_matrix(n)
    w = np.linspace(1.0, 2.0, n)
    # D @ x = diff(x, prepend=x[0]) -> row 0 is zero, row t is x[t]-x[t-1]
    d = np.eye(n) - np.eye(n, k=-1)
    d[0, :] = 0.0
    take = min(k, n)
    m = np.zeros((n, k), dtype=np.float64)
    m[:, :take] = (c[:take, :] @ (np.diag(w) @ d)).T
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _tonal_embed_map(n: int, k: int) -> np.ndarray:
    """(n, min(k, n-1)) map for the unweighted tonal_embedding; unlike
    tile_embedding it is not zero-padded."""
    c = dct2_matrix(n)
    take = min(k, max(0, n - 1))
    return c[1 : 1 + take, :].T.astype(np.float32)


def _tree_sum(terms):
    """Pairwise sum: ((t0 + t1) + (t2 + t3)) + ..., an odd last term
    carried up a level."""
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + terms[len(terms) - len(terms) % 2:]
    return terms[0]


def _apply_map(tiles: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(..., N) tiles times the (N, k) map in float32: the products
    tiles[..., t] * m[t], summed pairwise (the order of the JAX package's
    CPU dot for N up to 6)."""
    mt = torch.from_numpy(m).to(tiles.device)
    tiles = tiles.to(torch.float32)
    return _tree_sum([tiles[..., t, None] * mt[t] for t in range(m.shape[0])])


def _normalize_rows(e: torch.Tensor) -> torch.Tensor:
    nrm = torch.sqrt(row_sum(e * e))[..., None]
    return torch.where(nrm > _NORM_EPS, e / torch.where(nrm > 0, nrm, 1.0), e)


def tile_embedding_batch(tiles: torch.Tensor, k: int = EMBED_K) -> torch.Tensor:
    """(B, N) tiles -> (B, k) normalized tonal-head embeddings."""
    return _normalize_rows(_apply_map(tiles, _tile_embed_map(tiles.shape[-1], k)))


def transient_embedding_batch(tiles: torch.Tensor, k: int = 16) -> torch.Tensor:
    """(B, N) tiles -> (B, min(k, N) zero-padded to k) transient
    embeddings, normalized over the real coefficients only."""
    n = tiles.shape[-1]
    e = _apply_map(tiles, _transient_embed_map(n, k))
    take = min(k, n)
    real = _normalize_rows(e[..., :take])
    if take < k:
        return torch.cat([real, real.new_zeros((*e.shape[:-1], k - take))], dim=-1)
    return real


def tonal_embedding_batch(tiles: torch.Tensor, k: int = 16) -> torch.Tensor:
    """(B, N) tiles -> (B, min(k, N-1)) unweighted tonal embeddings."""
    return _normalize_rows(_apply_map(tiles, _tonal_embed_map(tiles.shape[-1], k)))


def multi_head_embedding_batch(tiles: torch.Tensor, tonal_k: int = 8,
                               transient_k: int = 8) -> torch.Tensor:
    """(B, N) tiles -> (B, tonal_k + transient_k): the tonal head, then the
    transient head with its zero-pad at the tail (for N < transient_k:
    [tonal(tonal_k) | transient(N) | zeros(transient_k - N)])."""
    return torch.cat([tile_embedding_batch(tiles, k=tonal_k),
                      transient_embedding_batch(tiles, k=transient_k)], dim=-1)


# --- the single-tile forms (numpy in, numpy out) ----------------------------
# Each runs on `device`, "cuda" by default, as the JAX forms run on the
# default device; "cpu" runs them on the host.

def _one(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device(device))[None, :]


def tile_embedding(x, k: int = EMBED_K, device="cuda") -> np.ndarray:
    return tile_embedding_batch(_one(x, device), k=k)[0].cpu().numpy()


def transient_embedding(tile, k: int = 16, device="cuda") -> np.ndarray:
    e = transient_embedding_batch(_one(tile, device), k=k)[0].cpu().numpy()
    return e[: min(k, len(tile))]  # the unpadded vector


def tonal_embedding(tile, k: int = 16, device="cuda") -> np.ndarray:
    return tonal_embedding_batch(_one(tile, device), k=k)[0].cpu().numpy()


def multi_head_embedding(tile, tonal_k: int = 8, transient_k: int = 8,
                         device="cuda") -> np.ndarray:
    return multi_head_embedding_batch(_one(tile, device), tonal_k=tonal_k,
                                      transient_k=transient_k)[0].cpu().numpy()


def quick_energy(x) -> float:
    """Sum of squares."""
    x = np.asarray(x)
    return float(np.sum(x * x))


def correlation_upper_bound(r_c, d_c, r_norm, d_norm) -> float:
    """The |corr| <= 1 bound of a centered pair."""
    if d_norm < 1e-12 or r_norm < 1e-12:
        return 0.0
    return abs(float(np.dot(r_c, d_c))) / (r_norm * d_norm)
