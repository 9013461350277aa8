"""Domain-bank construction.

A domain is a tile_size-sample sliding window (stride domain_step) of the
signal, block-averaged down to range_size samples: bank[i, j] is the mean
of block_len = tile_size // range_size samples starting at
i*domain_step + j*block_len.

`n_domains_for`, `build_domains_host` and `bank_rows_host` are copied from
fwav_tpu/ops/domains.py (numpy, host side: the serialized bank).
`box_sums` and `build_bank` are the torch counterparts of its `box_sums`
and `build_bank_jax` (the device's bank, used by the exact search).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def n_domains_for(n_samples: int, tile_size: int, domain_step: int) -> int:
    """Number of sliding windows: 0 if the signal is shorter than a tile."""
    if n_samples < tile_size:
        return 0
    return (n_samples - tile_size) // domain_step + 1


def box_sums(x: torch.Tensor, width: int) -> torch.Tensor:
    """s[p] = sum(x[p : p + width]) for every position (tail positions wrap
    around; callers read only p <= len(x) - width). The same two-stage
    shifted-add order as the JAX package (width = b1*b2 + rem), so the
    sums agree bit for bit."""
    if width == 1:
        return x
    b1 = max(1, math.isqrt(width))
    b2 = width // b1
    s1 = x
    for t in range(1, b1):
        s1 = s1 + torch.roll(x, -t)
    out = s1
    for k in range(1, b2):
        out = out + torch.roll(s1, -k * b1)
    for t in range(b1 * b2, width):
        out = out + torch.roll(x, -t)
    return out


def build_bank(
    signal_padded: torch.Tensor,
    tile_size: int,
    range_size: int,
    domain_step: int,
    d_bucket: int,
    n_domains: int,
) -> torch.Tensor:
    """(d_bucket, range_size) bank from a bucket-padded normalized signal;
    rows >= n_domains are zero. Column j is the strided slice
    means[j*block_len :: domain_step] of the box-mean sequence."""
    block_len = tile_size // range_size
    nb = signal_padded.shape[0]
    means = box_sums(signal_padded, block_len) * (1.0 / block_len)
    need = (range_size - 1) * block_len + (d_bucket - 1) * domain_step + 1
    if need > nb:
        means = torch.cat([means, means.new_zeros(need - nb)])
    span = (d_bucket - 1) * domain_step + 1
    bank = torch.stack(
        [
            means[j * block_len : j * block_len + span : domain_step]
            for j in range(range_size)
        ],
        dim=1,
    )
    rows = torch.arange(d_bucket, device=bank.device)
    return torch.where((rows < n_domains)[:, None], bank, 0.0)


def build_domains_host(
    signal: np.ndarray, tile_size: int, range_size: int, domain_step: int = 1
) -> np.ndarray:
    """The host bank, for serialization: float64 cumulative sums turn
    every block mean into two lookups."""
    d = n_domains_for(len(signal), tile_size, domain_step)
    if d == 0:
        return np.zeros((0, range_size), dtype=np.float32)
    return bank_rows_host(
        signal, tile_size, range_size, domain_step, np.arange(d, dtype=np.int64)
    )


def bank_rows_host(signal, tile_size: int, range_size: int, domain_step: int,
                   rows: np.ndarray) -> np.ndarray:
    """Build only the given bank rows; cumulative sums cover only
    [min(rows), max(rows) + tile span)."""
    signal = np.asarray(signal, dtype=np.float32)
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return np.zeros((0, range_size), dtype=np.float32)
    block_len = tile_size // range_size
    span = range_size * block_len
    s0 = int(rows.min()) * domain_step
    s1 = min(len(signal), int(rows.max()) * domain_step + span)
    seg = signal[s0:s1]
    cs = np.zeros(len(seg) + 1, dtype=np.float64)
    np.cumsum(seg, dtype=np.float64, out=cs[1:])

    d = len(rows)
    contiguous = d > 1 and rows[-1] - rows[0] == d - 1 and bool(
        np.all(np.diff(rows[:: max(1, d // 16)]) > 0)
    ) and bool(np.all(np.diff(rows) == 1)) if d > 1 else True
    if contiguous:
        # column j of the bank is a strided slice of the cumulative sums
        out = np.empty((d, range_size), dtype=np.float32)
        base = rows[0] * domain_step - s0
        for j in range(range_size):
            lo = base + j * block_len
            a = cs[lo + block_len : lo + block_len + d * domain_step : domain_step]
            b = cs[lo : lo + d * domain_step : domain_step]
            np.multiply(a - b, 1.0 / block_len, out=out[:, j], casting="unsafe")
        return out

    # scattered rows: gather per column with 1-D index vectors
    out = np.empty((d, range_size), dtype=np.float32)
    base = rows * domain_step - s0
    for j in range(range_size):
        lo = base + j * block_len
        np.multiply(
            cs[lo + block_len] - cs[lo], 1.0 / block_len,
            out=out[:, j], casting="unsafe",
        )
    return out
