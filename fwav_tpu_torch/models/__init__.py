from .decode import decompress_audio
from .encode import compress_audio, compress_audio_arrays, prune_bank
from .stream import compress_audio_streaming

__all__ = [
    "compress_audio", "compress_audio_arrays", "compress_audio_streaming",
    "decompress_audio", "prune_bank",
]
