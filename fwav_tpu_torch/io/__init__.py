from .compact import load_compressed_compact, parse_decode_hint, save_compressed_compact
from .container import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    save_compressed,
)
from .wav import read_wav, read_wav_mono, write_wav

__all__ = [
    "MATCH_DTYPE", "load_compressed", "load_compressed_arrays",
    "load_compressed_compact", "parse_decode_hint", "read_wav",
    "read_wav_mono", "save_compressed", "save_compressed_compact", "write_wav",
]
