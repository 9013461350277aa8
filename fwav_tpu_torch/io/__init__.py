from .compact import load_compressed_compact, parse_decode_hint, save_compressed_compact
from .container import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    matches_to_struct,
    save_compressed,
    save_compressed_streaming,
    struct_to_matches,
)
from .multich import load_compressed_multi, save_compressed_multi
from .wav import read_wav, read_wav_mono, write_wav

__all__ = [
    "MATCH_DTYPE", "load_compressed", "load_compressed_arrays",
    "load_compressed_compact", "load_compressed_multi", "matches_to_struct",
    "parse_decode_hint", "read_wav", "read_wav_mono", "save_compressed",
    "save_compressed_compact", "save_compressed_multi", "save_compressed_streaming",
    "struct_to_matches", "write_wav",
]
