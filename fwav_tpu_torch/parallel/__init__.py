"""Multi-device encode and decode over a (dp, tp) mesh of torch devices
(the counterpart of fwav_tpu/parallel)."""

from .mesh import DP_AXIS, TP_AXIS, Mesh, fetch_global, init_distributed, make_mesh
from .shard import compress_audio_sharded

__all__ = [
    "DP_AXIS",
    "TP_AXIS",
    "Mesh",
    "compress_audio_sharded",
    "fetch_global",
    "init_distributed",
    "make_mesh",
]
