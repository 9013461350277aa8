from .buckets import bucket, pad_to
from .device import resolve_device
from .logging import device_banner, logger
from .metrics import compression_ratio, compute_snr, x_realtime
from .trace import collect_phases, phase, torch_profile

__all__ = [
    "bucket", "collect_phases", "compression_ratio", "compute_snr", "device_banner",
    "logger", "pad_to", "phase", "resolve_device", "torch_profile", "x_realtime",
]
