"""The one generator of traffic: a pool of files from a mix's parameters
and a seed, and the order in which a closed-loop client sends them.

A mix (`traffic/<name>.json`) gives the pool's size, the range of file
lengths and, for each content parameter, the range it is drawn from. The
lengths are the same for every seed: the pool's files are spread evenly
over the range (file i of P at min + (max - min)(i + 1/2)/P), so that
every seed does the same amount of work. The seed draws each file's
content and the order of the requests.

The content is speech-like 16-bit audio: a chirp whose frequency wobbles,
two steady tones, noise, and a digital silence gap at a regular interval,
rounded to int16 sample values (what a WAV reader gives for a 16-bit
file).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Content parameters a mix must give, each as [low, high].
CONTENT = ("chirp_amp", "chirp_base_hz", "chirp_dev_hz", "chirp_rate_hz", "tone_amp",
           "tone_hz", "high_amp", "high_hz", "noise", "gap_every_s", "gap_s")


@dataclasses.dataclass
class File:
    index: int
    seconds: float
    samples: np.ndarray   # int16 sample values as float32
    params: dict


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def make_signal(seconds: float, sr: int, p: dict, rng: np.random.Generator) -> np.ndarray:
    """Speech-like content of the given parameters, as int16 values."""
    t = np.arange(int(sr * seconds)) / sr
    f = p["chirp_base_hz"] + p["chirp_dev_hz"] * np.sin(2 * np.pi * p["chirp_rate_hz"] * t)
    sig = p["chirp_amp"] * np.sin(2 * np.pi * f * t * 8)
    sig += p["tone_amp"] * np.sin(2 * np.pi * p["tone_hz"] * t)
    sig += p["high_amp"] * np.sin(2 * np.pi * p["high_hz"] * t)
    sig += p["noise"] * rng.standard_normal(len(t))
    k = 1
    while (a := int((p["gap_every_s"] * k - 0.3) * sr)) < len(t):
        sig[a : a + int(p["gap_s"] * sr)] = 0.0
        k += 1
    return np.clip(np.round(sig * 0.5 * (2**15 - 1)), -32768, 32767).astype(np.float32)


def lengths(mix: dict) -> list[float]:
    lo, hi = mix["seconds"]
    n = mix["pool_files"]
    return [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]


def build(mix: dict, sr: int, seed: int) -> list[File]:
    """The pool of one mix and seed."""
    missing = [k for k in CONTENT if k not in mix["content"]]
    if missing:
        raise ValueError(f"traffic {mix.get('name')!r} lacks {missing}")
    rng = rng_for(seed, 1)
    files = []
    for i, sec in enumerate(lengths(mix)):
        p = {k: float(rng.uniform(*mix["content"][k])) for k in CONTENT}
        files.append(File(i, sec, make_signal(sec, sr, p, rng), p))
    return files


def order(n_files: int, seed: int):
    """The request order: endless passes over the pool, each pass a fresh
    seeded permutation, so every file is sent equally often."""
    rng = rng_for(seed, 2)
    while True:
        yield from (int(i) for i in rng.permutation(n_files))


def sample(requested: list[int], longest: int, k: int, seed: int,
           groups: dict | None = None) -> list[int]:
    """Files that were requested, drawn from the seed: the longest, one of
    each group (`groups`: file -> its shape key) that does not hold it,
    and more up to k in all."""
    pool = sorted(set(requested))
    rng = rng_for(seed, 3)
    must = {longest} if longest in pool else set()
    by_group: dict = {}
    for i in pool:
        by_group.setdefault((groups or {}).get(i), []).append(i)
    for members in by_group.values():
        if not must & set(members):
            must.add(int(rng.choice(members)))
    rest = [i for i in pool if i not in must]
    n = min(max(0, k - len(must)), len(rest))
    pick = rng.choice(rest, size=n, replace=False) if rest else []
    return sorted(must | {int(i) for i in pick})
