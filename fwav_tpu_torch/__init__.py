"""fwav_tpu_torch — the FWAV fractal audio codec on PyTorch and CUDA.

The port of fwav_tpu (JAX on a TPU) to one NVIDIA H100: the same public
API and the same .fwav bytes, with the search kernels of the encode
written by hand in CUDA (fwav_tpu_torch/csrc). It imports torch and numpy,
never jax or fwav_tpu. Entry points take an explicit `device`: "cuda" by
default; "cpu" runs the kernels' plain PyTorch versions.

The configuration, container and WAV names load with the package; the
encode, decode and ops names load at first use, so that `python -m
fwav_tpu_torch info` or `snr` never imports the kernels' module.
"""

import importlib

from .config import (
    DAMPED_DECODE_DAMPING,
    EMBED_K,
    FWAV_VERSION,
    TOP_K,
    DecoderConfig,
    EncoderConfig,
    VADConfig,
)
from .io import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    load_compressed_compact,
    load_compressed_multi,
    parse_decode_hint,
    read_wav,
    read_wav_mono,
    save_compressed,
    save_compressed_compact,
    save_compressed_multi,
    save_compressed_streaming,
    write_wav,
)
from .utils import compute_snr

__version__ = "0.1.0"

#: Names loaded at first use, by the module that holds them.
_LAZY = {
    **dict.fromkeys(
        ("PACK_B_MAX", "compress_audio", "compress_audio_arrays", "compress_audio_packed",
         "compress_audio_streaming", "decompress_audio", "decompress_segment",
         "prune_bank", "process_file_compress", "process_file_decompress"), ".models"),
    **dict.fromkeys(("multi_head_embedding", "tile_embedding", "tonal_embedding",
                     "transient_embedding"), ".ops.dct"),
    "voiced_detection": ".ops.vad",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value


__all__ = sorted([
    "DAMPED_DECODE_DAMPING", "EMBED_K", "FWAV_VERSION", "TOP_K", "DecoderConfig",
    "EncoderConfig", "VADConfig", "MATCH_DTYPE", "compute_snr", "load_compressed",
    "load_compressed_arrays", "load_compressed_compact", "load_compressed_multi",
    "parse_decode_hint", "read_wav", "read_wav_mono", "save_compressed",
    "save_compressed_compact", "save_compressed_multi", "save_compressed_streaming",
    "write_wav", *_LAZY,
])
