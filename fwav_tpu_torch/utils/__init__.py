from .buckets import bucket, pad_to
from .device import resolve_device
from .metrics import compute_snr

__all__ = ["bucket", "compute_snr", "pad_to", "resolve_device"]
