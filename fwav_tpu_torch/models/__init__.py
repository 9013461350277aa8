from .decode import decompress_audio
from .encode import compress_audio, compress_audio_arrays, prune_bank

__all__ = ["compress_audio", "compress_audio_arrays", "decompress_audio", "prune_bank"]
