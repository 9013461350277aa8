"""`fwav_tpu_torch.compress_audio_packed` on the clips of one call: each
pool file cut into a clip corpus's 16 clips (reference/packed.py `cut`),
int16 sample values in memory, the codec given the knobs a user sets. The
answer is the 16 results joined in call order, as the reference joins
its own.

Each request also keeps the change of the program's packing counter
(ops/kernels.py PACKS) with the time it was sent; a program without the
counter leaves no record."""

from __future__ import annotations

import time

import numpy as np

from .. import calls
from ..reference import compare
from ..reference import packed as ref_packed


def join(parts: list[compare.Answer]) -> compare.Answer:
    """One answer of a call's clips: ranges in call order, each clip's
    rows offset by the earlier clips' bank rows, the banks stacked; the
    range and length counts summed, every other header field the clips'
    common value (None where they differ)."""
    offsets = np.cumsum([0] + [len(p.bank) for p in parts[:-1]])
    header = {}
    for k in parts[0].header:
        vals = [p.header.get(k) for p in parts]
        if k in ("n_ranges", "original_len"):
            header[k] = sum(vals)
        else:
            header[k] = vals[0] if len(set(vals)) == 1 else None
    return compare.Answer(
        header,
        np.concatenate([p.live for p in parts]),
        np.concatenate([p.rows + k for p, k in zip(parts, offsets)]),
        np.concatenate([p.sym for p in parts]),
        np.concatenate([p.s for p in parts]),
        np.concatenate([p.o for p in parts]),
        bank=np.concatenate([p.bank for p in parts]))


class Entry:
    #: Samples of a whole clip (reference/packed.py CLIP).
    CLIP = ref_packed.CLIP

    def __init__(self, config: dict, files, workdir: str, device: str = "cuda"):
        import fwav_tpu_torch
        from fwav_tpu_torch.ops import kernels

        self._encode = fwav_tpu_torch.compress_audio_packed
        self._packs = getattr(kernels, "PACKS", None)
        self.sr = config["sample_rate"]
        self.sw = config["sampwidth"]
        enc = config["encoder"]
        self.kw = dict(tile_size=enc["tile_size"], energy_thresh=enc["energy_thresh"],
                       search=enc["search"], objective=enc["objective"], device=device)
        self.clips = [ref_packed.split(f.samples, self.CLIP) for f in files]
        self.latest: dict = {}
        #: (send time, the counter's change) of every request
        self.packs: list = []

    def request(self, i: int) -> None:
        t = time.perf_counter()
        before = dict(self._packs) if self._packs is not None else None
        self.latest[i] = self._encode(self.clips[i], self.sr, self.sw, **self.kw)
        if before is not None:
            self.packs.append((t, {k: v - before[k] for k, v in self._packs.items()}))

    def answer(self, i: int) -> compare.Answer:
        return join([compare.from_arrays(r) for r in self.latest[i]])

    def pack_totals(self, requests) -> dict | None:
        """The counter's changes summed over the records sent inside
        `requests` (harness.Request); None where none of them left one."""
        sent = [t for t, _ in self.packs]
        total: dict = {}
        for r in requests:
            k = int(np.searchsorted(sent, r.t0))
            if k < len(sent) and sent[k] <= r.t1:
                for name, v in self.packs[k][1].items():
                    total[name] = total.get(name, 0) + v
        return total or None

    @classmethod
    def reference(cls, cfg, samples, device: str, lowp: bool = False):
        return ref_packed.encode(samples, cfg, device, lowp, cls.CLIP)

    @classmethod
    def kernel_calls(cls, cfg, n_samples: int) -> list[dict]:
        return [c for a, b in ref_packed.cut(n_samples, cls.CLIP)
                for c in calls.single_calls(cfg, b - a)]
