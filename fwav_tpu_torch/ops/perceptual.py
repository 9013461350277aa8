"""Perceptual weighting ops: the torch counterpart of
fwav_tpu/ops/perceptual.py.

- mel_filterbank / get_mel_filterbank: a numpy Slaney-scale mel bank
  (librosa.filters.mel(htk=False, norm='slaney')), copied;
- compute_transient_mask: the local energy-rise mask, copied (numpy);
- transient_envelope and perceptual_error_batch: the mel- and
  transient-weighted L2 of candidate tiles against a target, in torch;
- pruned_affine_search: the mirrored affine solve with energy-ratio
  pruning and the weighted error, pruned candidates masked to +inf.

None of these is on the encode's path; they are the reference's public
surface. The two torch functions run on `device`, "cuda" by default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

_EPS = 1e-12


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp, min_log_hz * np.exp(logstep * (m - min_log_mel)))


def mel_filterbank(sr: int = 44100, n_fft: int = 1024, n_mels: int = 40,
                   fmin: float = 20.0, fmax=None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized mel filterbank."""
    fmax = fmax or sr // 2
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))

    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        lower = (fftfreqs - lo) / max(ctr - lo, 1e-10)
        upper = (hi - fftfreqs) / max(hi - ctr, 1e-10)
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
        weights[i] *= 2.0 / (hi - lo)  # Slaney area normalization
    return weights.astype(np.float32)


def get_mel_filterbank(sr=44100, n_fft=1024, n_mels=40, fmin=20, fmax=None):
    """mel_filterbank under the reference's name and signature."""
    return mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax)


def compute_transient_mask(signal, frame_size: int = 256) -> np.ndarray:
    """Local energy-rise transient mask, normalized to [0, 1]."""
    signal = np.abs(np.asarray(signal, dtype=np.float32))
    mask = np.zeros_like(signal)
    if len(signal) > frame_size:
        mask[frame_size:] = np.maximum(0.0, signal[frame_size:] - signal[:-frame_size])
    mask /= mask.max() + 1e-8
    return mask


def _f32(x, dev) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def transient_envelope(r: torch.Tensor) -> torch.Tensor:
    """|first difference| envelope, zero-padded at the tail."""
    env = torch.abs(r[..., 1:] - r[..., :-1])
    return torch.nn.functional.pad(env, (0, 1))


def _taper(n: int, mel_weights, dev):
    """The default mel-ish taper linspace(1, 0.5) or the given weights."""
    if mel_weights is None:
        return torch.linspace(1.0, 0.5, n, dtype=torch.float32, device=dev)
    return _f32(mel_weights, dev)


def perceptual_error_batch(candidate_tiles, target_tile, mel_fb=None, transient_mask=None,
                           transient_weight: float = 1.0, device="cuda"):
    """Weighted L2 between candidates (K, N) and a target (N,), a (K,)
    tensor on `device`: the weights are a taper (linspace(1, 0.5) unless
    `mel_fb` is given) times (1 + w * the target's transient envelope)."""
    dev = resolve_device(device)
    tiles = _f32(candidate_tiles, dev)
    r = _f32(target_tile, dev)
    mel_weights = _taper(r.shape[-1], mel_fb, dev)
    env = transient_envelope(r)
    if transient_mask is not None:
        env = env * _f32(transient_mask, dev)
    diff = (tiles - r[None, :]) * mel_weights[None, :]
    diff = diff * (1.0 + transient_weight * env[None, :])
    return torch.linalg.norm(diff, dim=-1)


def pruned_affine_search(range_block, domain_idxs, bank, transient_weight: float = 1.0,
                         mel_weights=None, transient_mask=None,
                         energy_ratio_bounds=(0.25, 4.0), device="cuda"):
    """The mirrored affine solve, on `device`, over a candidate list with
    energy-ratio pruning and the perceptually weighted error: candidates
    whose centered energy is outside `energy_ratio_bounds` of the range's
    (or flat) are masked to +inf, originals come before mirrors and the
    first minimum wins. Returns (idx, s, o, sym, err) of the one range; (-1, 0, 0, 0,
    inf) when no candidate survives."""
    dev = resolve_device(device)
    r = _f32(range_block, dev)
    cand = torch.as_tensor(np.asarray(domain_idxs), dtype=torch.int64, device=dev)
    bank = _f32(bank, dev)
    n = r.shape[0]

    tiles = bank[cand.clamp(min=0)]                              # (K, N)
    tiles2 = torch.cat([tiles, tiles.flip(-1)], dim=0)           # originals, then mirrors
    sym_flags = torch.cat([torch.zeros(len(cand), dtype=torch.uint8, device=dev),
                           torch.ones(len(cand), dtype=torch.uint8, device=dev)])
    idx2 = torch.cat([cand, cand])

    r_mean = r.mean()
    r_c = r - r_mean
    r_energy = (r_c * r_c).sum()
    d_mean = tiles2.mean(dim=1)
    d_c = tiles2 - d_mean[:, None]
    d_energy = (d_c * d_c).sum(dim=1)

    lo, hi = energy_ratio_bounds
    ratio = d_energy / (r_energy + _EPS)
    valid = (ratio > lo) & (ratio < hi) & (idx2 >= 0) & (d_energy > 1e-8)
    num = d_c @ r_c
    s = torch.where(d_energy > 1e-8, num / torch.where(d_energy > 0, d_energy, 1.0), 0.0)
    o = r_mean - s * d_mean

    env = transient_envelope(r) if transient_mask is None else _f32(transient_mask, dev)
    weight = _taper(n, mel_weights, dev) * (1.0 + transient_weight * env)
    recon = s[:, None] * tiles2 + o[:, None]
    err = torch.linalg.norm((recon - r[None, :]) * weight[None, :], dim=1)
    err = torch.where(valid, err, float("inf"))
    pick = int(torch.argmin(err))
    if not bool(torch.isfinite(err[pick])):
        return -1, 0.0, 0.0, 0, float(err[pick])
    return int(idx2[pick]), float(s[pick]), float(o[pick]), int(sym_flags[pick]), float(err[pick])
