"""`fwav_tpu_torch.compress_audio_arrays` on one file's int16 samples; the
answer is its records and bank, in memory. The codec gets the knobs a user
sets (tile, energy threshold, search, objective); the rest are its
defaults, which the configuration file states and the reference runs."""

from __future__ import annotations

from .. import calls
from ..reference import compare
from ..reference import encode as ref_encode


class Entry:
    def __init__(self, config: dict, files, workdir: str, device: str = "cuda"):
        import fwav_tpu_torch

        self._encode = fwav_tpu_torch.compress_audio_arrays
        self.sr = config["sample_rate"]
        self.sw = config["sampwidth"]
        enc = config["encoder"]
        self.kw = dict(tile_size=enc["tile_size"], energy_thresh=enc["energy_thresh"],
                       search=enc["search"], objective=enc["objective"], device=device)
        self.files = files
        self.latest: dict = {}

    def request(self, i: int) -> None:
        self.latest[i] = self._encode(self.files[i].samples, self.sr, self.sw, **self.kw)

    def answer(self, i: int) -> compare.Answer:
        return compare.from_arrays(self.latest[i])

    @staticmethod
    def reference(cfg, samples, device: str, lowp: bool = False):
        return ref_encode.encode(samples, cfg, device, lowp)

    @staticmethod
    def kernel_calls(cfg, n_samples: int) -> list[dict]:
        return calls.single_calls(cfg, n_samples)
