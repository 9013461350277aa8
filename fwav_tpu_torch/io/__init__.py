from .container import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    save_compressed,
)
from .wav import read_wav, read_wav_mono, write_wav

__all__ = [
    "MATCH_DTYPE", "load_compressed", "load_compressed_arrays",
    "read_wav", "read_wav_mono", "save_compressed", "write_wav",
]
