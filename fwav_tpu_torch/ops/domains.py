"""Domain-bank construction.

A domain is a tile_size-sample sliding window (stride domain_step) of the
signal, block-averaged down to range_size samples: bank[i, j] is the mean
of block_len = tile_size // range_size samples starting at
i*domain_step + j*block_len.

`n_domains_for`, `build_domains_host`, `bank_rows_host`,
`build_domains_np` (the reference's formulation, for tests),
`frame_ranges` and `apply_symmetry` are copied from
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
    """s[p] = sum(x[p : p + width]) for every position along the last axis
    (tail positions wrap around within their own row, never into a
    neighbouring file of a stack; callers read only p <= len - width). The
    same two-stage shifted-add order as the JAX package (width = b1*b2 +
    rem), so the sums agree bit for bit."""
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


def build_bank(
    signal_padded: torch.Tensor,
    tile_size: int,
    range_size: int,
    domain_step: int,
    d_bucket: int,
    n_domains,
    row_offset: int = 0,
    d_rows: int | None = None,
) -> torch.Tensor:
    """(d_rows or d_bucket, range_size) rows [row_offset, row_offset +
    d_rows) of the d_bucket-row bank of a bucket-padded normalized signal;
    rows whose global index is >= n_domains are zero. Column j is the
    strided slice means[j*block_len :: domain_step] of the box-mean
    sequence. A stack signal_padded (B, nb) with n_domains a (B,) integer
    tensor on its device gives (B, rows, range_size). A bank row shard (the
    tp branches of the mesh encode) holds the full bank's rows bit for
    bit."""
    block_len = tile_size // range_size
    nb = signal_padded.shape[-1]
    if d_rows is None:
        d_rows = d_bucket
    row_offset = min(max(int(row_offset), 0), d_bucket - d_rows)
    means = box_sums(signal_padded, block_len) * (1.0 / block_len)
    need = (range_size - 1) * block_len + (d_bucket - 1) * domain_step + 1
    if need > nb:
        means = torch.cat(
            [means, means.new_zeros((*means.shape[:-1], need - nb))], dim=-1)
    lo = row_offset * domain_step
    span = (d_rows - 1) * domain_step + 1
    bank = torch.stack(
        [
            means[..., lo + j * block_len : lo + j * block_len + span : domain_step]
            for j in range(range_size)
        ],
        dim=-1,
    )
    rows = row_offset + torch.arange(d_rows, device=bank.device)
    if torch.is_tensor(n_domains):
        n_domains = n_domains[..., None]
    return torch.where((rows < n_domains)[..., None], bank, 0.0)


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


def build_domains_np(
    signal: np.ndarray, tile_size: int, range_size: int, domain_step: int = 1
) -> np.ndarray:
    """The reference's formulation of the bank (sliding windows, trim,
    reshape, mean), for tests and as a host fallback."""
    signal = np.asarray(signal, dtype=np.float32)
    if len(signal) < tile_size:
        return np.zeros((0, range_size), dtype=np.float32)
    windows = np.lib.stride_tricks.sliding_window_view(signal, tile_size)[::domain_step]
    block_len = tile_size // range_size
    usable = block_len * range_size
    trimmed = windows[:, :usable]
    return trimmed.reshape(len(windows), range_size, block_len).mean(
        axis=2, dtype=np.float32
    )


def frame_ranges(signal, range_size: int, hop=None) -> np.ndarray:
    """Strided frame view of the signal (the reference's public helper)."""
    hop = hop or range_size
    signal = np.asarray(signal)
    total = signal.shape[0]
    if total < range_size:
        return np.empty((0, range_size), dtype=signal.dtype)
    num_frames = 1 + (total - range_size) // hop
    shape = (num_frames, range_size)
    strides = (signal.strides[0] * hop, signal.strides[0])
    return np.lib.stride_tricks.as_strided(signal, shape=shape, strides=strides)


def apply_symmetry(tile):
    """[tile, mirrored tile]."""
    tile = np.asarray(tile)
    return [tile, tile[::-1]]
