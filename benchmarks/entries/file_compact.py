"""`fwav_tpu_torch.models.codec.process_file_compress` on a 16-bit WAV
that set-up wrote, with compact=True (the v2 container, the pruned bank,
the decode hint); the answer is the container it wrote. Files over 2^22
samples take the streaming encode there, and the reference follows."""

from __future__ import annotations

import os
import wave

import numpy as np

from .. import calls
from ..reference import compare, v2
from ..reference import encode as ref_encode
from ..reference import stream as ref_stream


def write_wav16(path: str, samples: np.ndarray, sr: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.astype("<i2").tobytes())


class Entry:
    #: Files longer than this (samples) stream: the CLI's rule.
    STREAM_ABOVE = ref_stream.STREAMING_THRESHOLD

    def __init__(self, config: dict, files, workdir: str, device: str = "cuda"):
        from fwav_tpu_torch.models.codec import process_file_compress

        self._compress = process_file_compress
        enc = config["encoder"]
        self.kw = dict(tile=enc["tile_size"], energy_thresh=enc["energy_thresh"],
                       search=enc["search"], objective=enc["objective"], compact=True,
                       device=device)
        self.files = files
        self.indir = os.path.join(workdir, "in")
        self.outdir = os.path.join(workdir, "out")
        os.makedirs(self.indir)
        os.makedirs(self.outdir)
        self.paths = []
        for f in files:
            p = os.path.join(self.indir, f"f{f.index}.wav")
            write_wav16(p, f.samples, config["sample_rate"])
            self.paths.append(p)
        self.latest: dict = {}

    def request(self, i: int) -> None:
        res = self._compress(self.paths[i], self.outdir, **self.kw)
        if "error" in res:
            raise RuntimeError(res["error"])
        self.latest[i] = res["output"]

    def answer(self, i: int) -> compare.Answer:
        with open(self.latest[i], "rb") as fh:
            return compare.from_container(v2.parse(fh.read()))

    @classmethod
    def reference(cls, cfg, samples, device: str, lowp: bool = False):
        if len(samples) > cls.STREAM_ABOVE:
            return ref_stream.encode_stream(samples, cfg, device, lowp)
        return ref_encode.encode(samples, cfg, device, lowp)

    @classmethod
    def kernel_calls(cls, cfg, n_samples: int) -> list[dict]:
        if n_samples > cls.STREAM_ABOVE:
            return calls.stream_calls(cfg, n_samples)
        return calls.single_calls(cfg, n_samples)
