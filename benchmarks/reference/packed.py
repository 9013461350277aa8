"""The plain reference of one packed call over a clip corpus: one pool
file cut into the clips of one call, each clip encoded on its own by the
single-file reference (reference/encode.py), the answers joined in call
order.

The cut is Speech Commands' format: WHOLE clips of exactly `clip`
samples (1 s at 16 kHz) and SHORT clips that share what is left, each
from half a clip to a whole one. The split point and the short clips'
places in the call are drawn from the file's length alone, so that every
seed gives a file of that length the same clips' lengths, and so the
same shape buckets.

The packed program promises each file the records of its single encode,
so the clips' single references are the call's semantics. Plain PyTorch
and NumPy; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .. import pool
from .encode import Encoded, Settings, encode as encode_one

#: Samples of a whole clip: 1 s at the corpus's 16 kHz.
CLIP = 16000
#: Whole clips of a call, and the shorter ones that share the rest.
WHOLE = 14
SHORT = 2


def cut(n_samples: int, clip: int = CLIP) -> list[tuple[int, int]]:
    """(start, stop) of each clip of a file of n_samples, in call order:
    consecutive pieces of the file, WHOLE of `clip` samples and SHORT of
    clip / 2 to clip each."""
    rest = n_samples - WHOLE * clip
    lo, hi = max(clip // 2, rest - clip), min(clip, rest - clip // 2)
    if lo > hi:
        raise ValueError(f"{n_samples} samples do not cut into {WHOLE} clips of {clip} "
                         f"and {SHORT} of {clip // 2} to {clip}")
    rng = pool.rng_for(n_samples, 4)
    first = int(rng.integers(lo, hi + 1))
    lengths = [clip] * (WHOLE + SHORT)
    a, b = sorted(int(k) for k in rng.choice(WHOLE + SHORT, size=SHORT, replace=False))
    lengths[a], lengths[b] = first, rest - first
    stops = np.cumsum(lengths)
    return [(int(s - n), int(s)) for s, n in zip(stops, lengths)]


def split(samples: np.ndarray, clip: int = CLIP) -> list[np.ndarray]:
    """The clips of one file, in call order."""
    return [samples[a:b] for a, b in cut(len(samples), clip)]


def join(parts: list[Encoded]) -> Encoded:
    """One answer of a call's clips: the ranges in call order, each clip's
    rows offset by the earlier clips' bank rows, the banks stacked."""
    offsets = np.cumsum([0] + [len(e.bank) for e in parts[:-1]])
    return Encoded(
        n_ranges=sum(e.n_ranges for e in parts),
        original_len=sum(e.original_len for e in parts),
        live=np.concatenate([e.live for e in parts]),
        idx=np.concatenate([np.where(e.idx >= 0, e.idx + k, -1)
                            for e, k in zip(parts, offsets)]),
        ranges=np.concatenate([e.ranges for e in parts]),
        bank=np.concatenate([e.bank for e in parts]),
        s=np.concatenate([e.s for e in parts]),
        o=np.concatenate([e.o for e in parts]),
        sym=np.concatenate([e.sym for e in parts]),
    )


def encode(samples: np.ndarray, cfg: Settings, device="cpu", lowp: bool = False,
           clip: int = CLIP) -> Encoded:
    """The reference's answer for one call: the file's clips, each encoded
    alone, joined."""
    return join([encode_one(c, cfg, device, lowp) for c in split(samples, clip)])
