"""Voiced/silent detection with hysteresis.

`frame_energies_np`, `hysteresis_np` and `voiced_detection` are copied from
fwav_tpu/ops/vad.py (numpy, host side). `hysteresis` and `voiced_mask` are
the torch counterparts of its `hysteresis_jax` and `voiced_mask_jax`: the
per-sample mask the encode core computes on the device.

Every reduction here is written as explicit elementwise adds in a fixed
order, so the CPU and CUDA runs of the same function give the same bits:
the frame energy is a left-to-right sum over the frame, and the 5-tap
smoothing is shifted adds, never `conv1d` (cuDNN runs float32 convolutions
in TF32 by default).

The torch functions work along the last axis, so a stack of files (a
leading file axis, one true length per file) goes through them at once
and each file gets what it gets alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .affine import row_mean


def frame_energies_np(signal: np.ndarray, frame_size: int) -> np.ndarray:
    """Per-frame mean energy over reflect-padded frames."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    n_frames = (n + frame_size - 1) // frame_size
    pad_len = n_frames * frame_size - n
    padded = np.pad(signal, (0, pad_len), mode="reflect") if pad_len else signal
    frames = padded.reshape(n_frames, frame_size)
    return np.mean(frames * frames, axis=1)


def hysteresis_np(energies: np.ndarray, hi: float, lo: float) -> np.ndarray:
    """State turns on above `hi`, off below `lo`, holds otherwise; initial
    state off. The state after frame i is the sign of the most recent
    on/off event at or before i."""
    energies = np.asarray(energies)
    on = energies > hi
    off = energies < lo  # on wins when both hold
    event = np.where(on, 1, np.where(off & ~on, -1, 0)).astype(np.int8)
    pos = np.arange(len(energies))
    marked = np.where(event != 0, pos, -1)
    last = np.maximum.accumulate(marked)
    state = np.where(last >= 0, event[np.clip(last, 0, None)] > 0, False)
    return state.astype(np.uint8)


def voiced_detection(
    signal,
    frame_size: int = 64,
    energy_threshold: float = 1e-4,
    smooth_window: int = 5,
    low_threshold=None,
):
    """Per-sample 0/1 voiced mask, same length as `signal` (host version)."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    energies = frame_energies_np(signal, frame_size)

    if smooth_window > 1:
        kernel = np.ones(smooth_window, dtype=np.float32) / smooth_window
        energies = np.convolve(energies, kernel, mode="same")

    if low_threshold is None:
        low_threshold = energy_threshold * 0.5

    mask = hysteresis_np(energies, energy_threshold, low_threshold)
    return np.repeat(mask, frame_size)[:n]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float threshold as a float32 scalar tensor: comparing float32 data
    against the rounded threshold is what the JAX package does. Filled on
    the device, with no copy from the host (see ops/affine.py row_mean)."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=like.device)


def hysteresis(energies: torch.Tensor, hi, lo) -> torch.Tensor:
    """Forward-fill of the last on/off event with `torch.cummax`, along
    the last axis."""
    on = energies > _f32(hi, energies)
    off = (energies < _f32(lo, energies)) & ~on
    event = torch.where(on, 1, torch.where(off, -1, 0)).to(torch.int8)
    pos = torch.arange(energies.shape[-1], dtype=torch.int64, device=energies.device)
    marked = torch.where(event != 0, pos, -1)
    last = torch.cummax(marked, dim=-1).values
    state = (last >= 0) & (event.gather(-1, last.clamp(min=0)) > 0)
    return state.to(torch.uint8)


def _smooth(energies: torch.Tensor, width: int) -> torch.Tensor:
    """`np.convolve(e, ones(width)/width, mode="same")` as shifted adds
    over a zero-padded copy, along the last axis."""
    half = width // 2
    k = 1.0 / width
    pad = energies.new_zeros((*energies.shape[:-1], half))
    ext = torch.cat([pad, energies, pad], dim=-1)
    n = energies.shape[-1]
    out = ext[..., 0:n] * k
    for i in range(1, width):
        out = out + ext[..., i : i + n] * k
    return out


def voiced_mask(
    signal_padded: torch.Tensor,
    n,
    frame_size: int,
    energy_threshold: float,
    smooth_window: int = 5,
    low_threshold=None,
) -> torch.Tensor:
    """Per-sample uint8 voiced mask over a bucket-padded float32 signal whose
    true length is `n`. The tail frame is reflect-padded by index arithmetic
    (position p >= n reads sample 2n-2-p), as np.pad(..., 'reflect') does.

    A stack of files is signal_padded (B, nb) with `n` a (B,) integer
    tensor on its device, one true length per file: the frame validity, the
    tail frame and the final cut are then per file."""
    if signal_padded.dim() == 1:
        n_t = torch.full((1,), int(n), dtype=torch.int64, device=signal_padded.device)
        return voiced_mask(signal_padded[None], n_t, frame_size, energy_threshold,
                           smooth_window, low_threshold)[0]
    dev = signal_padded.device
    B, nb = signal_padded.shape
    n = n.to(torch.int64)[:, None]                       # (B, 1)
    n_frames = (n + (frame_size - 1)) // frame_size
    n_frames_b = nb // frame_size
    fidx = torch.arange(n_frames_b, device=dev)[None, :]
    fvalid = fidx < n_frames

    def reflected(pos):  # the samples at pos, mirrored about each file's end
        refl = torch.where(pos < n, pos, 2 * n - 2 - pos).clamp(0, nb - 1)
        return signal_padded.gather(1, refl)

    if nb % frame_size == 0:
        framed = signal_padded.reshape(B, n_frames_b, frame_size)
        energies = row_mean(framed * framed)
        # the buffer's zero padding is not np.pad(..., 'reflect'): patch
        # the one, possibly partial, tail frame
        tf = n_frames - 1
        tw = reflected(tf * frame_size + torch.arange(frame_size, device=dev)[None, :])
        energies = torch.where(fidx == tf, row_mean(tw * tw)[:, None], energies)
    else:
        pos = torch.arange(n_frames_b * frame_size, device=dev)[None, :]
        framed = reflected(pos).reshape(B, n_frames_b, frame_size)
        energies = row_mean(framed * framed)
    energies = torch.where(fvalid, energies, 0.0)

    if smooth_window > 1:
        energies = torch.where(fvalid, _smooth(energies, smooth_window), 0.0)

    if low_threshold is None:
        low_threshold = energy_threshold * 0.5

    fmask = hysteresis(energies, energy_threshold, low_threshold)
    sample_mask = fmask.repeat_interleave(frame_size, dim=-1)
    if sample_mask.shape[-1] < nb:
        sample_mask = torch.cat(
            [sample_mask, sample_mask.new_zeros((B, nb - sample_mask.shape[-1]))], dim=-1
        )
    keep = torch.arange(nb, device=dev)[None, :] < n
    return torch.where(keep, sample_mask, 0).to(torch.uint8)
