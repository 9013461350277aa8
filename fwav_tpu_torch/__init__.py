"""fwav_tpu_torch — the FWAV fractal audio codec on PyTorch and CUDA.

The port of fwav_tpu (JAX on a TPU) to one NVIDIA H100: the same public
API and the same .fwav bytes, with the search kernels of the encode
written by hand in CUDA (fwav_tpu_torch/csrc). It imports torch and numpy,
never jax or fwav_tpu. Entry points take an explicit `device`: "cuda" by
default; "cpu" runs the kernels' plain PyTorch versions.
"""

from .config import DAMPED_DECODE_DAMPING, FWAV_VERSION, DecoderConfig, EncoderConfig
from .io import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    load_compressed_compact,
    parse_decode_hint,
    read_wav_mono,
    save_compressed,
    save_compressed_compact,
    write_wav,
)
from .models import compress_audio, compress_audio_arrays, decompress_audio, prune_bank
from .utils import compute_snr

__version__ = "0.1.0"

__all__ = [
    "DAMPED_DECODE_DAMPING", "FWAV_VERSION", "DecoderConfig", "EncoderConfig",
    "MATCH_DTYPE", "compress_audio", "compress_audio_arrays", "compute_snr",
    "decompress_audio", "load_compressed", "load_compressed_arrays",
    "load_compressed_compact", "parse_decode_hint", "prune_bank",
    "read_wav_mono", "save_compressed", "save_compressed_compact", "write_wav",
]
