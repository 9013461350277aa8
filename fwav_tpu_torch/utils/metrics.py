"""Quality metric (copied from fwav_tpu/utils/metrics.py)."""

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
