"""Quality and speed metrics (copied from fwav_tpu/utils/metrics.py)."""

from __future__ import annotations

import numpy as np


def compute_snr(original, reconstructed) -> float:
    """10*log10(sum(o^2)/sum((o-r)^2)) in float64 over the common prefix;
    +inf on zero noise."""
    n = min(len(original), len(reconstructed))
    orig = np.asarray(original[:n], dtype=np.float64)
    recon = np.asarray(reconstructed[:n], dtype=np.float64)
    noise = orig - recon
    signal_power = float(np.sum(orig * orig))
    noise_power = float(np.sum(noise * noise))
    if noise_power <= 0:
        return float("inf")
    return 10.0 * float(np.log10(signal_power / noise_power))


def x_realtime(n_samples: int, framerate: int, elapsed_s: float) -> float:
    """Encode/decode speed as a multiple of realtime playback."""
    if elapsed_s <= 0:
        return float("inf")
    return (n_samples / float(framerate)) / elapsed_s


def compression_ratio(in_bytes: int, out_bytes: int) -> float:
    """in_size / out_size; 0 for an empty output."""
    return in_bytes / out_bytes if out_bytes > 0 else 0.0
