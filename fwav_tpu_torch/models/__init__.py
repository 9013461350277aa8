from .codec import process_file_compress, process_file_decompress
from .decode import decompress_audio, decompress_segment
from .encode import (
    PACK_B_MAX,
    compress_audio,
    compress_audio_arrays,
    compress_audio_packed,
    prune_bank,
)
from .stream import compress_audio_streaming

__all__ = [
    "PACK_B_MAX", "compress_audio", "compress_audio_arrays", "compress_audio_packed",
    "compress_audio_streaming", "decompress_audio", "decompress_segment",
    "process_file_compress", "process_file_decompress", "prune_bank",
]
