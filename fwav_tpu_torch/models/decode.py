"""Decode: decompress_audio at the default s_damping=0.

At s_damping=0 the reference decoder's loop reaches its fixed point at the
first iteration, so decode is a host closed form with no device work:
`_decode_fixed_point_np` and `_fixed_point_chunk` are copied from
fwav_tpu/models/decode.py (numpy). The device loop that s_damping > 0
needs is not ported yet (ROADMAP.md: damped profile).
"""

from __future__ import annotations

import numpy as np

from ..io.container import matches_to_struct
from ..utils.device import resolve_device

_DENOM_EPS = 1e-12

#: Ranges per chunk of the closed form: bounds host temporaries.
DECODE_SHARD_RANGES = 1 << 22


def _decode_fixed_point_np(rec, domains, n_ranges, range_size, s_clip):
    """Host evaluation of the s_damping=0 fixed point, chunked so peak
    temporary memory stays bounded for multi-hour files."""
    out = np.empty(n_ranges * range_size, np.float32)
    for a in range(0, n_ranges, DECODE_SHARD_RANGES):
        b = min(n_ranges, a + DECODE_SHARD_RANGES)
        out[a * range_size : b * range_size] = _fixed_point_chunk(
            rec[a:b], domains, b - a, range_size, s_clip
        )
    return out


def _fixed_point_chunk(rec, domains, n_ranges, range_size, s_clip):
    idx = rec["idx"].astype(np.int64)
    invalid = idx < 0
    safe = np.where(invalid, 0, np.minimum(idx, max(len(domains) - 1, 0)))
    if len(domains):
        tiles = domains[safe].astype(np.float32)
    else:
        tiles = np.zeros((n_ranges, range_size), np.float32)
    tiles[invalid] = 0.0
    sym = np.where(invalid, False, rec["sym"].astype(bool))
    tiles = np.where(sym[:, None], tiles[:, ::-1], tiles)
    s_st = np.where(invalid, 0.0, rec["s"]).astype(np.float32)
    o_st = np.where(invalid, 0.0, rec["o"]).astype(np.float32)

    d_c = tiles - tiles.mean(axis=1, dtype=np.float32)[:, None]
    denom = (d_c * d_c).sum(axis=1, dtype=np.float32)
    valid = denom > _DENOM_EPS
    s_used = np.where(valid, np.float32(0.0), s_st)
    s_used = np.clip(s_used, -abs(s_clip), abs(s_clip)).astype(np.float32)
    return (s_used[:, None] * tiles + o_st[:, None]).reshape(-1)


def decompress_audio(
    matches,
    domains_array,
    n_ranges,
    range_size,
    iterations: int = 8,
    convergence_eps: float = 1e-3,
    use_gpu: bool = False,
    original_len=None,
    s_clip: float = 16.0,
    s_damping: float = 0.0,
    config=None,
    stats=None,
    device="cuda",
):
    """Reference-shaped decode. `matches` may be a tuple list, a dict of
    arrays or a record array; a DecoderConfig may replace the knobs.
    `stats` (a dict) receives the closed form's convergence counters:
    starting from zeros, iteration 1 lands on the fixed point with delta
    ||recon||, iteration 2 reproduces it with delta 0. `device` follows the
    encode's rule; the closed form itself runs on the host. `use_gpu` is
    accepted for the reference's signature."""
    del use_gpu
    resolve_device(device)
    if config is not None:
        iterations = config.iterations
        convergence_eps = config.convergence_eps
        s_clip = config.s_clip
        s_damping = config.s_damping
    if s_damping != 0 or iterations < 1:
        raise NotImplementedError(
            f"decode with s_damping={s_damping}, iterations={iterations} needs "
            "the device decode loop, which is not ported yet (ROADMAP.md: "
            "damped profile)"
        )
    n_ranges = int(n_ranges)
    range_size = int(range_size)
    if n_ranges == 0:
        _report_convergence(stats, 0, 0.0, convergence_eps)
        return np.zeros(int(original_len or 0), dtype=np.float32)

    rec = matches_to_struct(matches)
    if len(rec) != n_ranges:
        raise ValueError(f"{len(rec)} match records for {n_ranges} ranges")
    domains = np.ascontiguousarray(np.asarray(domains_array, dtype=np.float32))
    recon = _decode_fixed_point_np(rec, domains, n_ranges, range_size, s_clip)
    delta1 = float(np.linalg.norm(recon))
    if delta1 < convergence_eps or iterations == 1:
        _report_convergence(stats, 1, delta1, convergence_eps)
    else:
        _report_convergence(stats, 2, 0.0, convergence_eps)
    if original_len is not None:
        recon = recon[: int(original_len)]
    return recon


def _report_convergence(stats, iterations_run, final_delta, eps):
    if stats is not None:
        stats["iterations"] = int(iterations_run)
        stats["final_delta"] = float(final_delta)
        stats["converged"] = bool(final_delta < eps)
