"""Decode: decompress_audio.

The counterpart of fwav_tpu/models/decode.py. At s_damping=0 (with at
least one iteration) the reference decoder's loop reaches its fixed point
at the first iteration, so decode is a host closed form with no device
work: `_decode_fixed_point_np` and `_fixed_point_chunk` are copied from
the JAX package (numpy). Every other setting runs the iterative loop
(`_DecodeLoop`, the torch form of the JAX package's `build_decode_core`)
chunk by chunk, range-sharded over the dp rows of a mesh (`_decode_loop`);
one device is the one-cell mesh. `decompress_segment` decodes a window of
samples from the ranges that cover it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.container import matches_to_struct
from ..ops.affine import row_mean, row_sum
from ..parallel.mesh import DP_AXIS, as_mesh, fetch_global
from ..utils.buckets import bucket, pad_to
from .program import DEVICE_LOCK

_DENOM_EPS = 1e-12

#: Ranges per decode chunk (closed form and loop): bounds host and device
#: temporaries. Decode is per-range independent; the only coupling is the
#: loop's convergence delta, which becomes per chunk.
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


class _DecodeLoop:
    """The iterative reconstruction (fwav_tpu build_decode_core) of one
    slab, on the device of its tensors: idx (M,) int64 (-1 = sentinel,
    others within the bank), s_stored and o_stored (M,) float32, sym (M,)
    bool, bank (D, N) float32 with D >= 1. Each iteration refits the scale
    against the current reconstruction (blended (1 - d) s_stored + d s_opt
    for s_damping d > 0, else s_opt where the tile has centered energy) and
    clips it to +/- s_clip; `recon` (M, N) holds the latest. One `step` per
    iteration, so that a mesh can enqueue an iteration of every slab before
    it reads their deltas; `_decode_loop` runs the stop rule. The tiles,
    their centering and denominators do not change between iterations and
    are computed once. The per-range sums are left-to-right adds (no
    matmul, so no TF32); the norms are torch's float32 reductions."""

    def __init__(self, idx, s_stored, o_stored, sym, bank, s_clip: float,
                 s_damping: float):
        invalid = idx < 0
        tiles = bank[torch.where(invalid, 0, idx)]
        tiles = torch.where(invalid[:, None], 0.0, tiles)
        self.s_st = torch.where(invalid, 0.0, s_stored)
        self.o_st = torch.where(invalid, 0.0, o_stored)
        symb = sym & ~invalid
        self.tiles = torch.where(symb[:, None], tiles.flip(1), tiles)
        self.d_c = self.tiles - row_mean(self.tiles)[:, None]
        denom = row_sum(self.d_c * self.d_c)
        self.valid = denom > _DENOM_EPS
        self.safe_denom = torch.where(self.valid, denom, 1.0)
        self.c = abs(float(s_clip))
        self.s_damping = s_damping
        self.recon = torch.zeros_like(self.tiles)

    def step(self) -> torch.Tensor:
        """Enqueue one iteration; returns its relative delta (0-d, on the
        device)."""
        recon = self.recon
        r_c = recon - row_mean(recon)[:, None]
        num = row_sum(r_c * self.d_c)
        s_opt = torch.where(self.valid, num / self.safe_denom, 0.0)
        if self.s_damping > 0:
            s_used = (1.0 - self.s_damping) * self.s_st + self.s_damping * s_opt
        else:
            s_used = torch.where(self.valid, s_opt, self.s_st)
        s_used = s_used.clamp(-self.c, self.c)
        nxt = s_used[:, None] * self.tiles + self.o_st[:, None]
        prev_norm = torch.linalg.vector_norm(recon)
        d = torch.linalg.vector_norm(nxt - recon) / torch.where(prev_norm > 0, prev_norm, 1.0)
        self.recon = nxt
        return d


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
    mesh=None,
    stats=None,
    device="cuda",
):
    """Reference-shaped decode. `matches` may be a tuple list, a dict of
    arrays or a record array; a DecoderConfig may replace the knobs.
    `stats` (a dict) receives the convergence counters: 'iterations' (of
    the worst chunk), 'final_delta' (its last relative delta) and
    'converged'. The closed form (s_damping=0, iterations >= 1) runs on the
    host and reports the analytic counters: starting from zeros, iteration
    1 lands on the fixed point with delta ||recon||, iteration 2 reproduces
    it with delta 0. Every other setting runs the loop (`_decode_loop`) on
    `device`: "cuda" (the default, the card) or, when asked for, "cpu".
    `use_gpu` is accepted for the reference's signature.

    `mesh`: the loop runs range-sharded over the mesh's dp axis: each
    chunk pads to the JAX package's bucket of a multiple of dp * 256 ranges
    and dp row i iterates slab i on its first cell, with its own early
    stop; the report is the worst slab's. A mesh decides the device. The
    closed form ignores the mesh, as in JAX."""
    del use_gpu
    mesh = as_mesh(mesh, device)
    if config is not None:
        iterations = config.iterations
        convergence_eps = config.convergence_eps
        s_clip = config.s_clip
        s_damping = config.s_damping
    n_ranges = int(n_ranges)
    range_size = int(range_size)
    if n_ranges == 0:
        _report_convergence(stats, 0, 0.0, convergence_eps)
        return np.zeros(int(original_len or 0), dtype=np.float32)

    rec = matches_to_struct(matches)
    if len(rec) != n_ranges:
        raise ValueError(f"{len(rec)} match records for {n_ranges} ranges")
    domains = np.ascontiguousarray(np.asarray(domains_array, dtype=np.float32))
    if s_damping == 0 and iterations >= 1:
        recon = _decode_fixed_point_np(rec, domains, n_ranges, range_size, s_clip)
        delta1 = float(np.linalg.norm(recon))
        if delta1 < convergence_eps or iterations == 1:
            _report_convergence(stats, 1, delta1, convergence_eps)
        else:
            _report_convergence(stats, 2, 0.0, convergence_eps)
    else:
        recon = _decode_loop(rec, domains, n_ranges, range_size, int(iterations),
                             float(convergence_eps), s_clip, float(s_damping), mesh, stats)
    if original_len is not None:
        recon = recon[: int(original_len)]
    return recon


def decompress_segment(
    matches,
    domains_array,
    n_ranges,
    range_size,
    start,
    end,
    original_len=None,
    **decode_kwargs,
):
    """Decode samples [start, end) without reconstructing the file. The
    ranges do not overlap and each is reconstructed on its own, so decoding
    only the ranges that cover the window is exact: at s_damping=0 (the
    closed form) the result is bit-identical to slicing the full decode;
    the loop reaches the same fixed point, and only the iteration count of
    its early stop (a delta over the chunk it is given) can differ.

    start and end are sample offsets (end exclusive, clamped to the file);
    a negative start clamps to 0. `decode_kwargs` go to decompress_audio
    (`device` among them). Returns the float32 segment."""
    n_ranges = int(n_ranges)
    range_size = int(range_size)
    total = int(original_len) if original_len is not None else n_ranges * range_size
    start = max(0, int(start))
    end = min(int(end), total)
    if end <= start or n_ranges == 0:
        return np.zeros(0, np.float32)
    r0 = start // range_size
    r1 = min(-(-end // range_size), n_ranges)
    rec = matches_to_struct(matches)[r0:r1]
    seg = decompress_audio(rec, domains_array, r1 - r0, range_size, original_len=None,
                           **decode_kwargs)
    return seg[start - r0 * range_size : end - r0 * range_size]


def _chunk_inputs(r, n_dom: int, dev):
    """One chunk's records on `dev`: idx clamped to the bank's last row (a
    corrupt file must not fault the gather), s, o and the orientation."""
    idx = np.minimum(r["idx"].astype(np.int64), max(n_dom - 1, 0))
    return (torch.from_numpy(idx).to(dev),
            torch.from_numpy(np.ascontiguousarray(r["s"])).to(dev),
            torch.from_numpy(np.ascontiguousarray(r["o"])).to(dev),
            torch.from_numpy(r["sym"] != 0).to(dev))


def _bank_on(domains, range_size: int, dev):
    """The bank on `dev`; an empty bank becomes one zero row."""
    bank_np = domains if len(domains) else np.zeros((1, range_size), np.float32)
    return torch.from_numpy(bank_np).to(dev)


def _decode_loop(rec, domains, n_ranges, range_size, iterations, eps, s_clip,
                 s_damping, mesh, stats):
    """The loop over chunks of DECODE_SHARD_RANGES ranges, range-sharded
    over the dp rows of `mesh` (the JAX package's _decode_core_sharded; on
    the one-cell mesh its single-device loop): each chunk's range count
    pads to bucket(m, 256) rounded up to a multiple of dp * 256, and dp row
    i takes the slab [i * m / dp, (i + 1) * m / dp) of it, on its first
    cell. A slab holds only its real ranges (padding adds zeros to every
    sum; eager torch has no compile cache to pad for). The bank goes to each
    device once. Every iteration is enqueued on every slab before their
    deltas are read, one .item() each, so slabs on distinct cards overlap;
    each slab stops after `iterations` or once its relative delta falls
    under eps, compared in float32 as the JAX loop compares it. The report
    is the worst slab's; the slabs of other processes come through
    fetch_global. The loop holds DEVICE_LOCK."""
    dp = mesh.shape[DP_AXIS]
    eps32 = float(np.float32(eps))
    with DEVICE_LOCK:
        banks = {}
        pieces, its_max, delta_max = [], 0, 0.0
        for a in range(0, n_ranges, DECODE_SHARD_RANGES):
            b = min(n_ranges, a + DECODE_SHARD_RANGES)
            mloc = pad_to(bucket(b - a, 256), dp * 256) // dp
            loops, state = {}, {}
            for i in mesh.local_rows():
                lo, hi = a + i * mloc, min(b, a + (i + 1) * mloc)
                if lo >= hi:
                    continue  # a slab of padding only
                d = mesh.devices[i, 0]
                if d not in banks:
                    banks[d] = _bank_on(domains, range_size, d)
                loops[i] = _DecodeLoop(*_chunk_inputs(rec[lo:hi], len(domains), d), banks[d],
                                       s_clip, s_damping)
                state[i] = [0, float("inf")]
            active = [i for i in loops if iterations > 0]
            while active:
                deltas = {i: loops[i].step() for i in active}
                for i, d in deltas.items():
                    state[i] = [state[i][0] + 1, float(d.item())]
                active = [i for i in active
                          if state[i][0] < iterations and state[i][1] >= eps32]
            pieces.append(fetch_global({i: lp.recon for i, lp in loops.items()}, mesh))
            counts = fetch_global({i: np.array([v], np.float64) for i, v in state.items()},
                                  mesh)
            its_max = max(its_max, int(counts[:, 0].max()))
            delta_max = max(delta_max, float(counts[:, 1].max()))
    _report_convergence(stats, its_max, delta_max, eps)
    return np.concatenate(pieces).reshape(-1)


def _report_convergence(stats, iterations_run, final_delta, eps):
    if stats is not None:
        stats["iterations"] = int(iterations_run)
        stats["final_delta"] = float(final_delta)
        stats["converged"] = bool(final_delta < eps)
