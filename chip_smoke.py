#!/usr/bin/env python3
"""Smoke run of fwav_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py        # from the repository root

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of fwav_tpu_torch/csrc; any ptxas
   spill fails the run;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 10 s main paths (and K1 at the exact branch's largest
   bank) and of the 100 s stream (K1, K3 and K2 (all three objectives) at a
   shard's shapes, K3 at
   the global pass's whole-file shape), held to the near-tie bar of
   fwav_tpu_torch/ops/near_tie.py (K2, with one lobe per range and with
   K3's four, and its per-position table to exact equality), with
   CUDA-event times of both, the kernel's bound (bytes, tensor work and
   CUDA-core operations of these inputs at the card's published peaks)
   and its share of it; K4 (the staged refine) and its per-row table bit
   for bit at the shapes of the 100 s global pass, the staged single-shot
   encodes (60 s; tiles 512, 2048 and 8192) and a stack of 16 files at
   tile 512, K4 timed with the table made in the call and on one made
   before, the table alone;
4. slice: 10 s of 44.1 kHz 16-bit mono through the public API on the card
   (WAV write/read, compress_audio_arrays, prune_bank, save/load,
   decompress_audio): K1 and K2 launched, the sentinel count and the
   round-trip SNR of the JAX package's run, warm encode time;
5. damped: the damped profile's main path on the same file (encode with
   objective="damped": K3 once, K2 once over its four lobes; prune_bank; the v2
   container with the decode hint; load; the decode loop at the stored
   hint): the JAX package's sentinels, SNR and iteration count, the host
   run's records, bytes, warm encode time, decode time, peak memory;
6. stream: 100 s of bench.make_signal(100.0) through
   compress_audio_streaming at the default shard and halo (5 shards):
   damped (K3 then K2 once in every shard, then the whole-file global
   pass: K3 over every range of the file and K4 once over its 4 lobe
   columns; the profiled pass's records and busy time;
   the streaming prune, v2 with the hint, the decode loop at the stored
   hint), the same without the pass (it must gain more than 3 dB), and
   balanced (K1 then K2 per shard; the unpruned bank through the streaming
   v1 writer, the closed-form decode): the JAX package's sentinels, SNR,
   iterations and bytes, encode x-realtime, per-shard phase times, the
   encode's device time with and without the pass (torch.profiler; the
   pass's is the difference), decode time, peak memory; then the 12 s
   fixture of tests/test_torch_stream.py on the card against the host's
   plain run;
7. packed, kernels: a stack of 16 files in ONE launch of each kernel (the
   file is the slowest axis of its grid), with per-file valid / n_valid
   that differ, at 114,688 x 3,584 (K1 balanced, K3 damped, K2 with one
   lobe and with four, its table) and at the exact branch's 8,192 x
   24,576 (K1): equal bit for bit to the 16 single launches, held to the
   near-tie bar against the plain versions' loop over the files, timed
   with the bound of the 16 files beside it;
8. packed: compress_audio_packed on 16 ten-second files of one bucket
   (bench.make_signal scaled and dithered from 16 seeds) and one of
   another length, default and damped, and on 16 half-second clips (the
   exact branch): every file's records equal its compress_audio_arrays
   records on the card, each kernel launches once per stack, the stack's
   wall and busy time against 16 single calls, peak memory;
9. staged: the single-shot geometries whose coarse refine is the staged
   one (a 60 s file, over the window refine's 9 MB means cap; 10 s at tile
   512 and at tile 2048), balanced and damped: K1 or K3 and K4 once each
   (K4's table once where its windows are dense: damped), K2 not launched,
   the JAX package's sentinels and SNR, peak memory;
9b. wide_tiles: the 10 s file at tile 8192 (range size 32: coarse, the
   staged refine after K1, or damped K3) and at tile 16384 (range size 64:
   the exact branch), where K1 and K3 run their wide kernels
   (csrc/scan_wide.cuh; held to their plain versions at range sizes 17 to
   255 with the kernel checks of phase 3): the JAX package's sentinels
   and SNR (WIDE); `compress --tile 8192` and `--tile 16384` through the
   CLI, the API's bytes, and back;
10. multichannel and segment: a stereo pair through mid/side, both
   channels damped in one packed call, the v3 container with the decode
   hint, the hinted decode of both on the card and the inverse
   transform, against the same pipeline on the host; a segment of it by
   decompress_segment against the slice of the full decode;
11. cli: fwav_tpu_torch.cli.main in this process on the same files: the
   default compress of 10 s (the slice's file, byte for byte; info
   --verify, a bare decompress and snr: the slice's SNR), --compact (the
   damped phase's v2 file; the stored hint, 6 iterations), a segment
   (the slice of the full decode), the 100 s file (the streaming branch,
   default and --compact: the stream phase's SNRs), --batch --packed on
   the packed phase's 17 files (one launch of each kernel per stack,
   every entry "packed", each file as compress_audio_packed writes it),
   --batch with 1 and 4 workers (the same bytes), --channels ms (the
   multichannel phase's v3 file); each call's wall time, x-realtime and
   peak memory;
12. cli_process: `python -m fwav_tpu_torch warmup` and `compress` in
   subprocesses (the in-process file, byte for byte);
13. topk: `compress --search topk` of the 10 s file through the CLI:
   no kernel launched, TOPK's sentinels and SNR (the JAX CLI's CPU run);
14. mesh: fwav_tpu_torch.parallel on meshes of distinct cards where there
   are enough, else of cuda:0 repeated (cells that share a card run one
   after another: no speed-up is expected): 10 s default and damped
   through compress_audio_sharded at (2, 1), (1, 2), (2, 2) and (4, 1)
   (K1 or K3, K2 and its table once per cell), a 0.5 s file on the exact
   branch at tp 2 and 4 (K1 once per cell over its bank row shard), 100 s
   through the stream at (2, 2) balanced and damped, a packed stack of 16
   over 4 cells, the damped decode over dp 4 (each slab as it decodes
   alone), the CLI's missing-card error (--devices 2 --tp 2, exit code 1)
   and the API at (1, 2) writing the slice's v1 bytes, and two processes
   on the card joined by init_distributed (gloo on the host); every
   output byte for byte the single-device run's in this call, the
   sentinels and SNR the constants above, wall times beside the
   single-device ones;
14b. graphs: the device programs captured per shape key
   (fwav_tpu_torch/models/program.py) against the eager runs of the same
   calls: the 10 s default and damped encodes, a 0.5 s clip (exact), the
   staged plan (K4: tile 512 balanced and damped, tile 8192), stacks of 16
   ten-second files (also at tile 512, damped) and 16 clips, and the 100 s
   streams' shards,
   each replay's records byte-equal to the eager ones with the eager launch
   counts, each kernel those counts name found by name in a profiled
   replay, and the main paths' sentinels and SNR; two lengths of one
   bucket through one capture (a key's first call eager, its second
   captured); two threads replaying one key in turns;
   the enqueue eager against replayed (host clock), each program's capture
   time, graph nodes and pool bytes;
15. trace: the phase table of fwav_tpu_torch/utils/trace.py (the JAX
   package's phase names, TRACE_KEYS) on the 10 s default and damped
   encodes (device >= d2h >= host_bank, device + refit within the call's
   wall time), a packed stack of 16 and the 100 s stream in both profiles
   (each phase equal to its `stats` sum); a torch_profile trace of the
   default encode holding every phase range and K1's and K2's kernels, with
   the card's busy time beside the phases; busy_ms inside and outside a
   collector (the same work on the card and the same records of it, the
   ranges dropped as annotations; every profiled block starts on a card
   kept working, and the records the profiler lost are counted, a replayed
   program's graph launch owing a record for each of its graph's kernel,
   copy and memset nodes);
   the 10 s encode's median of 12 calls with and without a collector; and
   examples/torch_round_trip.py on the card.

Each slice runs with the launch counts set to 0 just before it and read
just after; a kernel of the slice that was not launched fails the run.
The last lines are the seconds of each part of the run, the nvidia-smi
line, a JSON summary of the kernels, and {"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The 10 s slice's reference numbers: the JAX package's CPU run of
# bench.make_signal(10.0) on its kernel path (EncoderConfig(use_pallas=True)).
# tests/test_torch_encode.py re-derives them.
SLICE_RANGES = 110250
SLICE_SENTINELS = 8265
SLICE_SNR_DB = 6.6275
SNR_TOL_DB = 0.01
# The damped slice's reference numbers, from the same JAX CPU run with
# objective="damped" (tests/test_torch_encode.py re-derives them): the
# records decoded at s_damping=0.25, and the main path through the pruned
# v2 container with the decode hint (its SNR, loop iterations and bytes).
DAMPED_SENTINELS = 8265
DAMPED_RECORDS_SNR_DB = 40.5409
DAMPED_SNR_DB = 40.5216
DAMPED_ITERATIONS = 6
DAMPED_COMPACT_BYTES_JAX = 486823
# The 100 s streaming paths' reference numbers: the JAX package's CPU run of
# bench.make_signal(100.0) through its compress_audio_streaming at the
# default shard and halo on its kernel path (EncoderConfig(use_pallas=True));
# tests/test_torch_stream.py re-derives them (marked slow). Balanced: the
# unpruned bank through the streaming v1 writer and the closed-form decode.
# Damped: the streaming prune, v2 with the decode hint, the loop at the
# stored hint; and the same without the global pass.
STREAM_SECONDS = 100.0
STREAM_RANGES = 1102500
STREAM_SENTINELS = 82650
STREAM_BALANCED_SNR_DB = 2.8238
STREAM_BALANCED_V1_BYTES = 89286198
STREAM_DAMPED_SNR_DB = 38.5558
STREAM_DAMPED_ITERATIONS = 6
STREAM_DAMPED_COMPACT_BYTES_JAX = 5376935
STREAM_DAMPED_OFF_SNR_DB = 31.4356
# The staged-refine paths' reference numbers: single-shot encodes whose
# coarse refine is the staged one (fwav_tpu_torch/models/encode.py
# _plan_search): a 60 s file, whose bank is over the window refine's 9 MB
# means cap, and 10 s files at tile 512 (coarse stride 64) and tile 2048
# (domain_step 2), of bench.make_signal, balanced and damped. From the JAX
# package's CPU run on its kernel path (EncoderConfig(use_pallas=True)) by
# scripts/derive_staged_constants.py; the SNR is of the records decoded with
# `decode`. tests/test_torch_encode.py re-derives them (marked slow).
STAGED = {
    "60s_balanced": {"seconds": 60.0, "kw": {}, "decode": {},
                     "n_ranges": 661500, "sentinels": 49590, "snr_db": 3.0129},
    "60s_damped": {"seconds": 60.0, "kw": {"objective": "damped"},
                   "decode": {"s_damping": 0.25},
                   "n_ranges": 661500, "sentinels": 49590, "snr_db": 39.6227},
    "tile512_balanced": {"seconds": 10.0, "kw": {"tile_size": 512}, "decode": {},
                         "n_ranges": 110250, "sentinels": 8265, "snr_db": 6.5902},
    "tile512_damped": {"seconds": 10.0, "kw": {"tile_size": 512, "objective": "damped"},
                       "decode": {"s_damping": 0.25},
                       "n_ranges": 110250, "sentinels": 8265, "snr_db": 41.7493},
    "tile2048_balanced": {"seconds": 10.0, "kw": {"tile_size": 2048}, "decode": {},
                          "n_ranges": 55125, "sentinels": 4130, "snr_db": 3.6296},
    "tile2048_damped": {"seconds": 10.0, "kw": {"tile_size": 2048, "objective": "damped"},
                        "decode": {"s_damping": 0.25},
                        "n_ranges": 55125, "sentinels": 4130, "snr_db": 12.0344},
}
# The wide tiles' reference numbers: 10 s single-shot encodes whose range
# size is over 16 (tile 8192: N = 32, domain_step 8; tile 16384: N = 64,
# domain_step 16), where K1 and K3 run their wide kernels
# (fwav_tpu_torch/csrc/scan_wide.cuh): tile 8192 takes the coarse search
# with the staged refine (K1 balanced; K3's four lobes damped), tile 16384
# the exact branch (K1 over the whole 28,672-row bank). From the JAX
# package's CPU run on its kernel path by scripts/derive_staged_constants.py;
# tests/test_torch_encode.py re-derives them.
WIDE = {
    "tile8192_balanced": {"seconds": 10.0, "kw": {"tile_size": 8192}, "decode": {},
                          "plan": ["coarse", 128, "staged"],
                          "n_ranges": 13782, "sentinels": 1029, "snr_db": 0.5834},
    "tile8192_damped": {"seconds": 10.0, "kw": {"tile_size": 8192, "objective": "damped"},
                        "decode": {"s_damping": 0.25}, "plan": ["coarse", 128, "staged"],
                        "n_ranges": 13782, "sentinels": 1029, "snr_db": 2.0747},
    "tile16384_exact": {"seconds": 10.0, "kw": {"tile_size": 16384}, "decode": {},
                        "plan": ["exact", 128, None],
                        "n_ranges": 6891, "sentinels": 513, "snr_db": 0.1634},
}
# The topk compatibility mode's reference numbers: the JAX package's CLI on
# the CPU, `compress bench10.wav OUT --search topk` then a bare
# `decompress`, on 10 s of bench.make_signal (range count, sentinel count,
# round-trip SNR). From scripts/derive_topk_constants.py;
# tests/test_torch_topk.py re-derives them (marked slow).
TOPK = {"seconds": 10.0, "n_ranges": 110250, "sentinels": 8265, "snr_db": 6.627}
#: The JAX package's phase keys per path (fwav_tpu_torch/utils/trace.py)
#: after the same call, which tests/test_torch_trace.py derives on the CPU
#: (the card has no JAX). "vad" joins the single-shot table only where the
#: host VAD runs (fast_mode=False; an all-sentinel file), the global_* keys
#: the stream's only with the damped pass. The port's table holds these
#: and PORT_KEYS' (port_keys).
_SINGLE_KEYS = ["d2h", "device", "host_bank", "refit"]
_STREAM_KEYS = ["dispatch", "fetch_wait", "host_refit", "vad"]
TRACE_KEYS = {
    "default": _SINGLE_KEYS,
    "damped": _SINGLE_KEYS,
    "fast_mode_false": sorted(_SINGLE_KEYS + ["vad"]),
    "all_sentinel": ["d2h", "device", "host_bank", "vad"],
    "packed": _SINGLE_KEYS,
    "stream_balanced": _STREAM_KEYS,
    "stream_damped": sorted(_STREAM_KEYS + ["global_dispatch", "global_fetch",
                                            "global_h2d", "global_pass"]),
}
#: The phases the port names beyond the JAX package's, per path of
#: TRACE_KEYS: the signal's preparation (`prep`) on every path, and the
#: stream's host glue, each shard's and the pass's input build and the
#: pass's refit of its winners.
PORT_KEYS = {"default": ["prep"], "damped": ["prep"], "fast_mode_false": ["prep"],
             "all_sentinel": ["prep"], "packed": ["prep"],
             "stream_balanced": ["prep", "shard_prep"],
             "stream_damped": ["global_refit", "prep", "shard_prep"]}


def port_keys(path: str) -> list:
    """The port's phase keys after a call on `path`, sorted."""
    return sorted(TRACE_KEYS[path] + PORT_KEYS[path])
#: A segment decoded by the loop at its default stop test against the slice
#: of the full decode, relative to the signal's peak: the stop test's delta
#: is over the chunk that is decoded, so the two may stop an iteration apart.
SEGMENT_RTOL = 1e-3
#: Card-vs-host decode bar: the loop's float32 sums run in another order on
#: the card; the samples are of order 1e4 (16-bit scale).
DECODE_ATOL = 1e-2
# The kernel-vs-plain bar is fwav_tpu_torch/ops/near_tie.py's
# (tests/test_pallas_search.py's): identical -inf sets (K1, K2) and -1
# entries (K3); at most 2 differing rows per 1,024, each a near-tie whose
# scores agree to its NEAR_TIE_RTOL (K3: float64 gains of both lists).

# Published peaks of one H100 SXM (NVIDIA's H100 datasheet):
# the bound of a kernel is the largest of its bytes over the memory rate,
# its numerators over the BF16 tensor rate (three BF16 products per tap,
# hi.hi + lo.hi + hi.lo, which carry 16 bits of each factor), and the
# operations that no multiply-add absorbs over the CUDA cores' issue rate
# (16,896 lanes at the 1.98 GHz boost clock). The card's power limit is
# printed beside it.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
CUDA_CORE_OPS_PER_S = 16896 * 1.98e9
#: K1 and K3, per pair, the screen of csrc/scan_tile.cuh. Balanced and
#: affine (B prescaled by sqrt(w)): max(|num_o|, |num_m|), the margin's
#: multiply-add, compare, mark. Damped: the fold, the clip compare, the
#: linear branch's multiply-add, square, weight, select, then the same
#: margin, compare and mark. The confirm of the few marked pairs is left out.
SCAN_EPILOGUE_OPS = {"sqrt": 4, "clip": 9}
#: K2's CUDA-core operations, its numerators aside (they are counted at
#: the tensor rate). Once per distinct position that a window reaches, for
#: N taps: the box mean (N - 1 adds, a multiply), denom as sum v^2 - s mean
#: (N multiply-adds, one more), then balanced: denom - s mean, denom + eps,
#: its square, a reciprocal, a multiply (5); affine: denom + eps and its
#: reciprocal (2); damped: denom + eps, its reciprocal, c denom (3).
REFINE_OPS_PER_POSITION = {"balanced": 5, "affine": 2, "damped": 3}
#: Per (range, position) pair, what no design can share across ranges.
#: Balanced and affine: fold, square, one multiply (by the weight or the
#: stored reciprocal); damped: fold, clip compare, the linear branch (2),
#: square, multiply, select; then compare and keep the score and the
#: position (3).
REFINE_OPS_PER_PAIR = {"balanced": 6, "affine": 6, "damped": 10}
REFINE_WINDOW = 160
#: K4's CUDA-core operations per scored bank row beside 3 per tap, by the
#: rule above (csrc/staged_refine.cu row_gain): per tap an add of the
#: row's mean, the centring and the energy's multiply-add (the mean's
#: division is the N-th of its N operations); the numerators go to the
#: tensor rate. Then + eps (1), the weight (balanced 6: - eps, N mean, its
#: square, the difference, denom squared, the division; affine and damped
#: 1, the reciprocal), the two gains (4), damped the threshold (2) and
#: each orientation's clip (6 each), the fold (2) and the running first
#: max (3). A division counts as one operation.
K4_OPS_PER_ROW = {"balanced": 16, "affine": 11, "damped": 25}
#: The same work as this K4 splits it (csrc/staged_refine.cu). A row's
#: terms, beside 3 per tap (the mean's add, the centring, the energy's
#: multiply-add): + eps (1), the weight (balanced 6, affine and damped 1),
#: damped the threshold (2); once per bank row where K4 makes its table,
#: else once per scored row. A scored row from the table is centred (1 a
#: tap, counted beside the numerators). The scoring, per scored
#: row, beside 2 per tap on the CUDA cores (the two numerators'
#: multiply-adds: no two ranges share a window, so no tensor-core reuse)
#: and, from the table, the centring:
#: the two gains (4), damped each orientation's clip (6 each), the fold
#: (2) and the running first max (3).
K4_TABLE_OPS_PER_ROW = {"balanced": 7, "affine": 2, "damped": 4}
K4_SCORE_OPS_PER_ROW = {"balanced": 9, "affine": 9, "damped": 21}
LIBRARY_NOTE = ("none: no single PyTorch call computes a running argmax or top-C of "
                "the clip-aware, weighted, orientation-folded gain, a refine around "
                "lobes, or its per-position table")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 2, inner: int = 1) -> float:
    """Median milliseconds of one fn() by CUDA events, over `reps` samples
    of `inner` back-to-back calls each (so that the host's launch overhead
    hides behind the card's work)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def kernel_ms(fn) -> float:
    """A kernel's time: 20 samples of 10 back-to-back launches."""
    return cuda_ms(fn, inner=10)


def graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median milliseconds of one fn() on the card alone: `inner` calls are
    captured in a CUDA graph and the graph is replayed, so no host time
    between launches is counted. For kernels shorter than the host takes to
    launch them, which kernel_ms would time as the host's launch rate. fn
    copies nothing from the host: K2 takes its n_valid as a device tensor
    here (device_counts), as the captured encode programs give it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps=reps) / inner


def device_counts(n_valid, dev):
    """K2's n_valid (an int, or one int per file) as the int32 device
    tensor the kernel reads: the same values, no copy from the host at
    the launch."""
    import torch

    return torch.tensor(n_valid, dtype=torch.int32).reshape(-1).to(dev)


def bound(terms: dict) -> dict:
    """The least time of a kernel: the largest of its terms (ms each)."""
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms}


def numerator_ms(count, N) -> float:
    """Both orientations' numerators of `count` pairs or positions on the
    tensor cores: N taps, three BF16 products each, 2 flop a product."""
    return count * 2 * N * 3 * 2 / BF16_FLOP_PER_S * 1e3


def scan_bound(M, N, n_valid, D, out_bytes_per_range, clip, files: int = 1) -> dict:
    """K1/K3 at M ranges x n_valid valid domains (of D): the screen on the
    CUDA cores, the numerators on the tensor cores, the ranges, bank and
    outputs once. For a stack, `files` files of M ranges and D domains
    each, n_valid the valid domains of all files together."""
    pairs = M * n_valid
    ops = SCAN_EPILOGUE_OPS["clip" if clip else "sqrt"]
    nbytes = files * (M * N * 4 + D * (N * 4 + 4 + 1 + (4 if clip else 0))
                      + M * out_bytes_per_range)
    return bound({
        "cuda_core_epilogue": pairs * ops / CUDA_CORE_OPS_PER_S * 1e3,
        "tensor": numerator_ms(pairs, N),
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    })


def stats_ops(N, objective) -> int:
    """CUDA-core operations of one position's statistics (see
    REFINE_OPS_PER_POSITION)."""
    return 2 * N + 1 + REFINE_OPS_PER_POSITION[objective]


def refine_bound(lobes, N, means_len, objective, stride) -> dict:
    """K2 with lobes (M,) or (M, C): the (range, position) pairs of every
    lobe >= 0, their numerators on the tensor cores and the per-pair rest
    on the CUDA cores; the statistics once per distinct position that a
    window reaches (at most means_len); the box means, the ranges, the
    lobes and the outputs once."""
    import torch

    M = int(lobes.shape[0])
    live = lobes[lobes >= 0]
    pairs = int(live.numel()) * REFINE_WINDOW
    first = torch.unique(live).long() * stride + (stride - REFINE_WINDOW // 2)
    reach = torch.zeros(means_len, dtype=torch.bool, device=lobes.device)
    t = torch.arange(REFINE_WINDOW, device=lobes.device)
    reach[(first[:, None] + t[None, :]).clamp(max=means_len - 1)] = True
    positions = int(reach.sum())
    ops = positions * stats_ops(N, objective) + pairs * REFINE_OPS_PER_PAIR[objective]
    return {"pairs": pairs, "distinct_positions": positions, **bound({
        "cuda_core": ops / CUDA_CORE_OPS_PER_S * 1e3,
        "tensor": numerator_ms(pairs, N),
        "bytes": (means_len * 4 + M * N * 4 + lobes.numel() * 4 + M * 8)
        / HBM_BYTES_PER_S * 1e3,
    })}


def stack_refine_bound(lobes, N, means_len, objective, stride) -> dict:
    """K2 over a stack, lobes (B, M) or (B, M, C): every term of
    refine_bound summed over the files, then the largest."""
    per_file = [refine_bound(lob, N, means_len, objective, stride) for lob in lobes]
    terms = {k: sum(f["bound_terms_ms"][k] for f in per_file)
             for k in per_file[0]["bound_terms_ms"]}
    return {"pairs": sum(f["pairs"] for f in per_file),
            "distinct_positions": sum(f["distinct_positions"] for f in per_file),
            **bound(terms)}


def stats_bound(N, means_len, objective) -> dict:
    """K2's table: every position's statistics once; the box means read
    and the table written once."""
    return bound({
        "cuda_core": means_len * stats_ops(N, objective) / CUDA_CORE_OPS_PER_S * 1e3,
        "bytes": means_len * 4 * 2 / HBM_BYTES_PER_S * 1e3,
    })


def timed(check, fn, plain_fn, plain_reps=20, plain_warmup=2, timer=kernel_ms) -> dict:
    """A check's numbers with the kernel's and the plain version's times
    and the kernel's share of its bound."""
    ms = timer(fn)
    return {**check, "ms": ms, "share_of_bound": check["bound_ms"] / ms,
            "plain_ms": cuda_ms(plain_fn, reps=plain_reps, warmup=plain_warmup)}


def k1_check(kernels, name, args, clip, range_block, **plain_timing):
    """K1 against its plain version on `args`, timed, with its bound."""
    from fwav_tpu_torch.ops import near_tie

    kw = {"s_clip": 16.0} if clip else {}
    a = args if clip else args[:4]
    M, N = a[0].shape
    check = {**near_tie.check_argmax(name, kernels.search_scan(*a, **kw),
                                     kernels.search_scan_ref(*a, **kw,
                                                             range_block=range_block)),
             "shape": [M, a[1].shape[1]],
             **scan_bound(M, N, int(a[3].sum()), a[1].shape[1], 8, clip)}
    return timed(check, lambda: kernels.search_scan(*a, **kw),
                 lambda: kernels.search_scan_ref(*a, **kw, range_block=range_block),
                 **plain_timing)


def k3_check(kernels, name, args, range_block, **plain_timing):
    """K3 (C = 4, s_clip 16) against its plain version, timed, with its
    bound; differing lists are held to the float64 gains."""
    from fwav_tpu_torch.ops import near_tie

    r_c, bank_t, w, valid, thresh = args
    k3 = (r_c, bank_t, w, valid, 4, thresh, 16.0)
    host = [None if x is None else x.cpu().numpy() for x in (r_c, bank_t, w, thresh)]

    def gain(idx, rows):
        return near_tie.topc_gain64(host[0][rows], host[1], host[2], host[3], 16.0, idx)

    check = near_tie.check_lists(name, kernels.topc_scan(*k3),
                                 kernels.topc_scan_ref(*k3, range_block=range_block), gain)
    M, N = r_c.shape
    check = {**check, "shape": [M, bank_t.shape[1], 4],
             **scan_bound(M, N, int(valid.sum()), bank_t.shape[1], 16, thresh is not None)}
    return timed(check, lambda: kernels.topc_scan(*k3),
                 lambda: kernels.topc_scan_ref(*k3, range_block=range_block), **plain_timing)


def k2_check(kernels, name, k2, **plain_timing):
    """K2 (its table and its scoring launch) against its plain version:
    equal bit for bit; timed whole and each kernel alone as replayed CUDA
    graphs (`eager_ms`: launched from the host, as the other kernels are
    timed), with its bound."""
    import torch

    from fwav_tpu_torch.ops import near_tie

    means_ext, lobes, ranges, n_valid, stride, block_len, objective, _ = k2
    N = int(ranges.shape[1])
    check = near_tie.check_argmax(name, kernels.refine_window(*k2),
                                  kernels.refine_window_ref(*k2))
    if check["idx_diff"] or check["max_abs_err"]:
        raise AssertionError(f"{name}: the kernel and its plain version differ: {check}")
    k2 = (*k2[:3], device_counts(n_valid, means_ext.device), *k2[4:])
    stats = kernels.window_stats(means_ext, N, block_len, objective)
    torch.cuda.synchronize()
    check = {**check, "shape": [*lobes.shape, int(means_ext.shape[0])],
             **refine_bound(lobes, N, int(means_ext.shape[0]), objective, stride),
             "score_ms": graph_ms(lambda: kernels.refine_window(*k2, stats=stats)),
             "stats_ms": graph_ms(lambda: kernels.window_stats(
                 means_ext, N, block_len, objective)),
             "eager_ms": kernel_ms(lambda: kernels.refine_window(*k2))}
    return timed(check, lambda: kernels.refine_window(*k2),
                 lambda: kernels.refine_window_ref(*k2), timer=graph_ms, **plain_timing)


def stats_check(kernels, name, means_ext, N, block_len, objective):
    """K2's per-position table against its plain version: exact equality."""
    import torch

    args = (means_ext, N, block_len, objective)
    got, want = kernels.window_stats(*args), kernels.window_stats_ref(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} table entries differ")
    check = {"rows": int(got.shape[0]), "max_abs_err": 0.0, "shape": list(got.shape),
             **stats_bound(N, int(means_ext.shape[0]), objective)}
    return timed(check, lambda: kernels.window_stats(*args),
                 lambda: kernels.window_stats_ref(*args), timer=graph_ms)


def k2_lobe_matrix(kernels, dev, seed, M, D, objective, n_valid, stride):
    """(M, 4) lobes as the main path hands them to K2: K3's top 4 on the
    seeded scan inputs (the transposed view of its (4, M) output), then,
    so that every case of the merge occurs, whole rows of -1, trailing -1
    slots, a lobe repeated within its row and a lobe whose window n_valid
    cuts (lobe 0's is cut by position 0)."""
    a = kernel_inputs(dev, seed, M, D, objective)
    lobes = kernels.topc_scan(*a[:4], 4, a[4], 16.0)
    lobes[::97] = -1
    lobes[1::53, 2:] = -1
    lobes[2::31, 3] = lobes[2::31, 0]
    lobes[3::41, 1] = (n_valid + stride // 2) // stride
    return lobes


def ptxas_summary(log: str) -> dict:
    """Registers and spills per kernel from nvcc's -Xptxas -v log; raises
    if any kernel spills."""
    import re

    entries, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            entries.setdefault(name, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            entries.setdefault(name, {})["registers"] = int(m.group(1))
    spilled = {k: v for k, v in entries.items() if v.get("spill")}
    if spilled:
        raise AssertionError(f"ptxas reports spills: {spilled}")

    def short(k):  # _ZN..18search_scan_kernelILi4ELb1EE.. -> search_scan_kernel<4,1>
        m = re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEv", k)
        return k if not m else f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"

    return {"kernels": len(entries), "spill_bytes": 0,
            "max_registers": max((v.get("registers", 0) for v in entries.values()), default=0),
            "registers": {short(k): v.get("registers") for k, v in entries.items()
                          if re.search(r"ILi4E", k) or "merge" in k or "wide" in k}}


def kernel_inputs(dev, seed: int, M: int, D: int, objective: str, N: int = 4):
    """Seeded K1 inputs: centered ranges of N taps, a bank and its weights."""
    import numpy as np
    import torch

    from fwav_tpu_torch.ops.affine import affine_stats
    from fwav_tpu_torch.ops.search import domain_thresh, domain_weights

    rng = np.random.default_rng(seed)
    r = rng.standard_normal((M, N)).astype(np.float32) * 0.3
    bank = rng.standard_normal((D, N)).astype(np.float32) * 0.3
    r_c = torch.from_numpy(r - r.mean(1, keepdims=True)).to(dev)
    bank_t = torch.from_numpy(bank).to(dev)
    mean, denom = affine_stats(bank_t)
    valid = torch.arange(D, device=dev) < D - 37
    return (r_c, bank_t.T.contiguous(), domain_weights(mean, denom, N, objective),
            valid, domain_thresh(denom, objective, 16.0))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from bench import make_signal
    import fwav_tpu_torch as port
    from fwav_tpu_torch.io import native
    from fwav_tpu_torch.models import encode as enc
    from fwav_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # records are compared byte for byte below: the host refit must be the
    # native one (its numpy fallback stores other s, o and err bits)
    if native._load() is None:
        raise AssertionError("the native library fwav_tpu_torch/_build/libfwavio.so did not load")
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    emit({"phase": "build", "seconds": build_s, "library": str(lib_path),
          "ptxas": ptxas_summary(log) if log else "up to date"})

    # seconds of each part of the run, printed at its end
    seconds, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    # --- kernels vs plain, at main-path shapes ----------------------------
    checks = {}
    M, D = 114688, 3584  # 10 s: padded ranges x stride-128 subsampled bank
    checks["k1_coarse"] = k1_check(kernels, "K1 coarse",
                                   kernel_inputs(dev, 0, M, D, "balanced"), False, 16384)
    # exact branch: the largest bank bucket under 32,768
    checks["k1_exact_damped"] = k1_check(kernels, "K1 exact damped",
                                         kernel_inputs(dev, 1, 8192, 24576, "damped"),
                                         True, 8192)
    sig = make_signal(10.0)
    raw_norm = torch.from_numpy(sig / np.abs(sig).max()).to(dev)
    n_valid, stride, block_len = 439977, 128, 256
    means_ext, _ = enc._means_setup(raw_norm, 4, block_len, stride, D)
    rng = np.random.default_rng(2)
    lobes = torch.from_numpy(rng.integers(-1, D - 3, M).astype(np.int32)).to(dev)
    ranges = torch.from_numpy(rng.standard_normal((M, 4)).astype(np.float32) * 0.3).to(dev)
    for objective in ("balanced", "affine", "damped"):
        k2 = (means_ext, lobes, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_{objective}"] = k2_check(kernels, f"K2 {objective}", k2)
        checks[f"ws_{objective}"] = stats_check(kernels, f"K2 table {objective}",
                                                means_ext, 4, block_len, objective)
    for objective in ("damped", "balanced"):
        lobes4 = k2_lobe_matrix(kernels, dev, 3, M, D, objective, n_valid, stride)
        k2 = (means_ext, lobes4, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_lobes4_{objective}"] = k2_check(kernels, f"K2 4 lobes {objective}", k2)
    for obj in ("damped", "balanced"):
        checks[f"k3_{obj}"] = k3_check(kernels, f"K3 {obj}",
                                       kernel_inputs(dev, 3, M, D, obj), 16384)
    stream_sig = make_signal(STREAM_SECONDS)
    stream_kernel_checks(kernels, enc, dev, stream_sig, checks)
    stack_kernel_checks(kernels, enc, dev, sig, checks)
    staged_kernel_checks(port, kernels, enc, dev, checks)
    staged_refine_checks(port, kernels, enc, dev, stream_sig, checks)
    mesh_kernel_checks(kernels, enc, dev, sig, stream_sig, checks)
    wide_kernel_checks(kernels, dev, checks)
    bank_kernel_checks(kernels, dev, checks)
    refit_kernel_checks(kernels, dev, checks)
    for key, val in checks.items():
        emit({"phase": "kernel", "check": key, "card": smi, **val})
    lap("kernels")

    # --- the slice through the public API ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "bench10.wav"
        port.write_wav(wav, sig, 44100, 2)
        signal, sr, sw = port.read_wav_mono(wav)
        kernels.reset_launch_counts()
        rec, bank, n_ranges, range_size, tile, step, thr, olen = (
            port.compress_audio_arrays(signal, sr, sw, device="cuda")
        )
        launches = dict(kernels.LAUNCHES)
        pruned, pbank = port.prune_bank(rec, bank)
        fwav = Path(tmp) / "bench10.fwav"
        port.save_compressed(fwav, pruned, pbank, range_size, sr, sw, tile, step, thr, olen)
        lrec, lbank, ln, lrs, *_, lolen = port.load_compressed_arrays(fwav)
        recon = port.decompress_audio(lrec, lbank, ln, lrs, original_len=lolen,
                                      device="cuda")
        snr = port.compute_snr(signal, recon)
        sentinels = int((rec["idx"] < 0).sum())
        fwav_bytes = fwav.stat().st_size
        api_files = {"default": fwav.read_bytes()}
    if min(launches[k] for k in ("search_scan", "refine_window", "window_stats")) < 1:
        raise AssertionError(f"the slice did not launch K1 and K2 with its table: {launches}")
    if n_ranges != SLICE_RANGES or sentinels != SLICE_SENTINELS:
        raise AssertionError(f"{sentinels} sentinels in {n_ranges} ranges")
    if not np.isfinite(recon).all() or recon.shape != signal.shape:
        raise AssertionError("the decode is not finite or has the wrong length")
    if abs(snr - SLICE_SNR_DB) > SNR_TOL_DB:
        raise AssertionError(f"SNR {snr} dB, expected {SLICE_SNR_DB} +/- {SNR_TOL_DB}")

    # the same slice on the host, through the plain versions
    rec_cpu = port.compress_audio_arrays(signal, sr, sw, device="cpu")[0]
    if not np.array_equal(rec_cpu["idx"] < 0, rec["idx"] < 0):
        raise AssertionError("the card's and the host's sentinel sets differ")
    cpu_diff = int((rec_cpu["idx"] != rec["idx"]).sum())
    if cpu_diff > 2 * -(-n_ranges // 1024):
        raise AssertionError(f"{cpu_diff} idx differ between card and host")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        port.compress_audio_arrays(signal, sr, sw, device="cuda")
        times.append(time.perf_counter() - t0)
    enc_s = statistics.median(times)
    cfg = port.EncoderConfig()
    raw_p, nr, nd, lb, db = enc._prep_signal(signal, cfg)
    raw = torch.from_numpy(raw_p).to(dev)
    core_span_ms = cuda_ms(
        lambda: enc.encode_core(raw, len(signal), nr, nd, lb, db, cfg), reps=5
    )
    emit({"phase": "slice", "card": smi, "seconds_audio": len(signal) / sr,
          "n_ranges": n_ranges, "sentinels": sentinels, "snr_db": snr,
          "launches": launches, "idx_diff_vs_host": cpu_diff,
          "fwav_bytes": fwav_bytes, "encode_s_median5": enc_s,
          "x_realtime": len(signal) / sr / enc_s, "core_span_ms_median5": core_span_ms,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})

    lap("slice")
    damped_launches, api_files["compact"] = damped_slice(port, kernels, enc, dev, smi,
                                                         signal, sr, sw)
    by_path = {"balanced": launches, "damped": damped_launches}
    lap("damped")
    for part, run in (("stream", lambda: stream_phase(port, kernels, smi, stream_sig)),
                      ("packed", lambda: packed_phase(port, kernels, enc, smi)),
                      ("staged", lambda: staged_phase(port, kernels, smi)),
                      ("wide_tiles", lambda: wide_phase(port, kernels, smi, sig))):
        by_path.update(run())
        lap(part)
    by_path["multichannel"], api_files["ms"] = multichannel_phase(port, kernels, smi)
    lap("multichannel")
    for part, run in (
            ("cli", lambda: cli_phase(port, kernels, smi, sig, stream_sig, api_files)),
            ("mesh", lambda: mesh_phase(port, kernels, smi, sig, stream_sig, api_files)),
            ("graphs", lambda: graphs_phase(port, kernels, smi, sig, stream_sig)),
            ("trace", lambda: trace_phase(port, kernels, smi, sig, stream_sig))):
        by_path.update(run())
        lap(part)
    emit({"phase": "seconds", "build": build_s, **seconds,
          "total_after_build": sum(seconds.values())})

    def summary(key, prefix, main_check, stack_check=None, wide=False):
        """Launches of every path, counted under the kernel's own key;
        times and bound at the main path's shape and for a stack of 16
        files in one launch; the largest error of all checks (the wide
        kernels': of the checks at range sizes over 16)."""
        def is_wide(name):
            return "wide" in name

        err = max(v["max_abs_err"] for k, v in checks.items()
                  if k.startswith(prefix) and is_wide(k) == wide)
        paths = {name: p[key] for name, p in by_path.items() if p.get(key)}
        main = checks[main_check]
        out = {"launches": sum(paths.values()), "launches_by_path": paths,
               "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "bound_term": main["bound_term"], "share_of_bound": main["share_of_bound"],
               "library_ms": None, "library_note": LIBRARY_NOTE, "card": smi}
        if stack_check:
            out["stack16"] = {k: checks[stack_check][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                "single_launch_ms", "stack_over_singles")}
        if wide:
            out["by_range_size"] = {k: {f: checks[k][f] for f in (
                "N", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")}
                for k in checks if k.startswith(prefix) and is_wide(k)}
        return out

    print(smi, flush=True)
    emit({"kernels": [
        {"name": "search_scan (K1)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/search_scan.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:67",
         **summary("search_scan", "k1_", "k1_coarse", "k1_stack16_balanced")},
        {"name": "refine_window (K2)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/refine_window.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:301",
         **summary("refine_window", "k2_", "k2_balanced", "k2_stack16_balanced")},
        {"name": "window_stats (K2's per-position table)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/refine_window.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:301",
         **summary("window_stats", "ws_", "ws_balanced", "ws_stack16_balanced")},
        {"name": "topc_scan (K3)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/topc_scan.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:141",
         **summary("topc_scan", "k3_", "k3_damped", "k3_stack16_damped")},
        {"name": "search_scan_wide (K1 at range sizes 17-255)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/scan_wide.cuh",
         "replaces": "fwav_tpu/ops/pallas_search.py:67",
         **summary("search_scan_wide", "k1_", "k1_wide_n32", wide=True)},
        {"name": "topc_scan_wide (K3 at range sizes 17-255)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/scan_wide.cuh",
         "replaces": "fwav_tpu/ops/pallas_search.py:141",
         **summary("topc_scan_wide", "k3_", "k3_wide_n32", wide=True)},
        {"name": "staged_refine (K4; no TPU counterpart: XLA's fusion of refine_from_lobes)",
         "route": "cuda", "source": "fwav_tpu_torch/csrc/staged_refine.cu",
         "replaces": "fwav_tpu/ops/search.py:470",
         **summary("staged_refine", "k4_", "k4_global_pass", "k4_stack16_tile512_damped"),
         "by_shape": {k: {f: checks[k][f] for f in (
             "shape", "N", "stride", "objective", "per_lobe", "scored_rows", "uses_table",
             "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "design_bound_ms",
             "design_bound_term", "design_share")} | {f: checks[k][f] for f in (
                 "score_ms", "stats_ms") if f in checks[k]}
             for k in checks if k.startswith("k4_")}},
        {"name": "staged_stats (K4's per-row table)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/staged_refine.cu",
         "replaces": "fwav_tpu/ops/search.py:470",
         **summary("staged_stats", "ks_", "ks_60s_damped", "ks_stack16_tile512_damped"),
         "by_shape": {k: {f: checks[k][f] for f in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")}
             for k in checks if k.startswith("ks_")}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def damped_slice(port, kernels, enc, dev, smi, signal, sr, sw):
    """The damped profile's main path on the card, held to the JAX CPU
    run's numbers and to the host run; returns its launch counts and the
    bytes of its v2 file."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        rec, bank, n_ranges, range_size, tile, step, thr, olen = (
            port.compress_audio_arrays(signal, sr, sw, objective="damped", device="cuda")
        )
        launches = dict(kernels.LAUNCHES)
        pruned, pbank = port.prune_bank(rec, bank)
        fwav = Path(tmp) / "bench10_damped.fwav"
        port.save_compressed_compact(fwav, pruned, pbank, range_size, sr, sw, tile, step,
                                     thr, olen, decode_damping=port.DAMPED_DECODE_DAMPING)
        hint = port.parse_decode_hint(fwav.read_bytes()[:128])
        loaded = port.load_compressed_arrays(fwav)
        lrec, lbank, ln, lrs, *_, lolen = loaded
        stats = {}
        recon = port.decompress_audio(lrec, lbank, ln, lrs, original_len=lolen,
                                      s_damping=hint, stats=stats, device="cuda")
        snr = port.compute_snr(signal, recon)
        sentinels = int((rec["idx"] < 0).sum())
        fwav_bytes = fwav.stat().st_size
        data = fwav.read_bytes()
    if min(launches[k] for k in ("topc_scan", "refine_window", "window_stats")) < 1:
        raise AssertionError(f"the damped slice did not launch K3 and K2 with its table: {launches}")
    if n_ranges != SLICE_RANGES or sentinels != DAMPED_SENTINELS:
        raise AssertionError(f"damped: {sentinels} sentinels in {n_ranges} ranges")
    if hint != port.DAMPED_DECODE_DAMPING:
        raise AssertionError(f"the decode hint read back is {hint}")
    if not np.isfinite(recon).all() or recon.shape != signal.shape:
        raise AssertionError("the damped decode is not finite or has the wrong length")
    if abs(snr - DAMPED_SNR_DB) > SNR_TOL_DB:
        raise AssertionError(f"damped SNR {snr} dB, expected {DAMPED_SNR_DB} +/- {SNR_TOL_DB}")
    if stats["iterations"] != DAMPED_ITERATIONS or not stats["converged"]:
        raise AssertionError(f"the decode loop stopped with {stats}")
    rec_stats = {}
    snr_records = port.compute_snr(signal, port.decompress_audio(
        rec, bank, n_ranges, range_size, original_len=olen, s_damping=hint,
        stats=rec_stats, device="cuda"))
    if abs(snr_records - DAMPED_RECORDS_SNR_DB) > SNR_TOL_DB:
        raise AssertionError(f"damped records SNR {snr_records} dB, expected "
                             f"{DAMPED_RECORDS_SNR_DB} +/- {SNR_TOL_DB}")

    # the same encode and decode on the host, through the plain versions
    rec_cpu = port.compress_audio_arrays(signal, sr, sw, objective="damped", device="cpu")[0]
    if not np.array_equal(rec_cpu["idx"] < 0, rec["idx"] < 0):
        raise AssertionError("damped: the card's and the host's sentinel sets differ")
    cpu_diff = int((rec_cpu["idx"] != rec["idx"]).sum())
    if cpu_diff > 2 * -(-n_ranges // 1024):
        raise AssertionError(f"damped: {cpu_diff} idx differ between card and host")
    stats_cpu = {}
    recon_cpu = port.decompress_audio(lrec, lbank, ln, lrs, original_len=lolen,
                                      s_damping=hint, stats=stats_cpu, device="cpu")
    decode_err = float(np.max(np.abs(recon_cpu - recon)))
    if decode_err > DECODE_ATOL or stats_cpu["iterations"] != stats["iterations"]:
        raise AssertionError(f"decode card vs host: max err {decode_err}, "
                             f"{stats} vs {stats_cpu}")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        port.compress_audio_arrays(signal, sr, sw, objective="damped", device="cuda")
        times.append(time.perf_counter() - t0)
    enc_s = statistics.median(times)
    decode_ms = cuda_ms(lambda: port.decompress_audio(
        lrec, lbank, ln, lrs, original_len=lolen, s_damping=hint, device="cuda"), reps=5)
    cfg = port.EncoderConfig(objective="damped")
    raw_p, nr, nd, lb, db = enc._prep_signal(signal, cfg)
    raw = torch.from_numpy(raw_p).to(dev)
    core_span_ms = cuda_ms(
        lambda: enc.encode_core(raw, len(signal), nr, nd, lb, db, cfg), reps=5
    )
    emit({"phase": "damped", "card": smi, "seconds_audio": len(signal) / sr,
          "n_ranges": n_ranges, "sentinels": sentinels, "decode_hint": hint,
          "snr_db": snr, "snr_records_db": snr_records, "decode_stats": stats,
          "launches": launches, "idx_diff_vs_host": cpu_diff,
          "decode_max_abs_err_vs_host": decode_err, "compact_bytes": fwav_bytes,
          "compact_bytes_jax_cpu": DAMPED_COMPACT_BYTES_JAX,
          "encode_s_median5": enc_s, "x_realtime": len(signal) / sr / enc_s,
          "core_span_ms_median5": core_span_ms, "decode_ms_median5": decode_ms,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    return launches, data


def stream_kernel_checks(kernels, enc, dev, sig, checks):
    """K3 at the global pass's whole-file shape, and K1, K3 and K2 at a
    shard's shapes, each against its plain version on the card."""
    import numpy as np
    import torch

    # one shard window: 2^20 samples and two 2^18 halos (1,572,864 bank
    # rows); 262,144 ranges against the stride-128 subsampled bank
    M1, D1 = 262144, 12288
    slow = {"plain_reps": 3, "plain_warmup": 1}
    checks["k1_shard_balanced"] = k1_check(
        kernels, "K1 shard balanced", kernel_inputs(dev, 6, M1, D1, "balanced"), False,
        16384, **slow)
    checks["k3_shard_damped"] = k3_check(
        kernels, "K3 shard damped", kernel_inputs(dev, 7, M1, D1, "damped"), 16384, **slow)
    # 100 s: padded ranges x stride-512 whole-file rows
    checks["k3_global_damped"] = k3_check(
        kernels, "K3 global", kernel_inputs(dev, 4, 1310720, 10240, "damped"), 32768, **slow)
    # K2 over one shard window's box-mean sequence
    nbw, stride, block_len = 1572864, 128, 256
    n_valid = nbw - 1024 + 1
    win = sig[:nbw]
    raw_norm = torch.from_numpy(win / np.abs(win).max()).to(dev)
    means_ext, _ = enc._means_setup(raw_norm, 4, block_len, stride, D1)
    rng = np.random.default_rng(5)
    lobes = torch.from_numpy(rng.integers(-1, D1 - 3, M1).astype(np.int32)).to(dev)
    ranges = torch.from_numpy(rng.standard_normal((M1, 4)).astype(np.float32) * 0.3).to(dev)
    for objective in ("balanced", "affine", "damped"):
        k2 = (means_ext, lobes, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_shard_{objective}"] = k2_check(kernels, f"K2 shard {objective}", k2,
                                                   plain_reps=5)
        checks[f"ws_shard_{objective}"] = stats_check(
            kernels, f"K2 table shard {objective}", means_ext, 4, block_len, objective)
        if objective == "affine":
            continue  # four lobes run balanced and damped only (K3's objectives)
        lobes4 = k2_lobe_matrix(kernels, dev, 7, M1, D1, objective, n_valid, stride)
        k2 = (means_ext, lobes4, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_shard_lobes4_{objective}"] = k2_check(
            kernels, f"K2 shard 4 lobes {objective}", k2, plain_reps=3, plain_warmup=1)


#: The wide kernels (fwav_tpu_torch/csrc/scan_wide.cuh) against their plain
#: versions: (check, wrapper, range size, ranges, domains, objective) at the
#: scans of the 10 s file's plans at tiles 4352, 8192 and 16384: the coarse
#: grids of the staged refine (K1 one lobe, K3 the damped profile's four),
#: the exact branch's whole bank at tile 16384, and K3 on that tile's coarse
#: grid (search="coarse"); then the exact branch at tiles 32768 (damped) and
#: 65280 (balanced), the widest block-shape classes (up to 128 and 255 taps).
#: scripts/compare_scan_kernels.py times the same list.
WIDE_CHECKS = [("k1_wide_n17", "search_scan", 17, 28672, 896, "balanced"),
               ("k3_wide_n17", "topc_scan", 17, 28672, 896, "damped"),
               ("k1_wide_n32", "search_scan", 32, 14336, 448, "balanced"),
               ("k3_wide_n32", "topc_scan", 32, 14336, 448, "damped"),
               ("k1_wide_n64_exact", "search_scan", 64, 7168, 28672, "balanced"),
               ("k3_wide_n64", "topc_scan", 64, 7168, 224, "damped"),
               ("k1_wide_n128_exact", "search_scan", 128, 3584, 14336, "damped"),
               ("k1_wide_n255_exact", "search_scan", 255, 1792, 6144, "balanced")]


def encode_scan_calls(tile_size: int, objective: str):
    """The K1 and K3 calls of one 10 s encode of bench.make_signal at
    `tile_size` on the card: [(name, args, kwargs)] in call order, each
    tensor cloned as the eager encode passed it (a captured replay calls no
    wrapper). For timing and counting the kernels on a real file's inputs
    (scripts/compare_scan_kernels.py, scripts/count_wide_marks.py)."""
    import torch
    from bench import make_signal

    from fwav_tpu_torch.models import encode as enc

    calls = []

    def record(name, fn):
        def wrapper(*args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                              dict(kw)))
            return fn(*args, **kw)
        return wrapper

    saved = enc.search_scan, enc.topc_scan
    enc.search_scan, enc.topc_scan = record("search_scan", saved[0]), record("topc_scan", saved[1])
    try:
        enc.compress_audio_arrays(make_signal(10.0), 44100, 2, tile_size=tile_size,
                                  objective=objective, device="cuda")
    finally:
        enc.search_scan, enc.topc_scan = saved
    if not calls:
        raise RuntimeError(f"the encode at tile {tile_size} ({objective}) called no scan")
    return calls


def wide_kernel_checks(kernels, dev, checks):
    """K1 and K3 at range sizes 17 to 255 (WIDE_CHECKS) against their
    plain versions: 0 differing rows and, for K1, 0 score error; timed,
    with the bound of these inputs."""
    slow = {"plain_reps": 3, "plain_warmup": 1}
    for key, scan, N, M, D, objective in WIDE_CHECKS:
        args = kernel_inputs(dev, 500 + N, M, D, objective, N=N)
        if scan == "search_scan":
            name = f"K1 wide N={N} {M} x {D} {objective}"
            out = k1_check(kernels, name, args, objective == "damped", 8192, **slow)
        else:
            name = f"K3 wide N={N} {M} x {D} x 4 {objective}"
            out = k3_check(kernels, name, args, 8192, **slow)
        if out["idx_diff"] or (scan == "search_scan" and out["max_abs_err"]):
            raise AssertionError(f"{name}: the kernel and its plain version differ: {out}")
        checks[key] = {**out, "N": N}


#: The serialized bank's kernel at the default geometry (tile 1024, 4
#: taps, step 1): a 10 s file and the longest of the 70 s pool.
BANK_CHECKS = [("bank_10s", 10.0), ("bank_94s", 94.0)]


def bank_kernel_checks(kernels, dev, checks):
    """bank_means against build_domains_host and its plain version (every
    bit), timed, with its bytes bound (the samples read and the bank
    written once); beside it the copy of its rows into pinned host memory
    (CUDA events) and the numpy build it replaces (host clock, median of
    5)."""
    import numpy as np
    import torch

    from bench import make_signal
    from fwav_tpu_torch.ops.domains import build_domains_host, n_domains_for

    for key, seconds in BANK_CHECKS:
        sig = make_signal(seconds)
        L, nd = len(sig), n_domains_for(len(sig), 1024, 1)
        x = np.zeros((1, -(-L // 4096) * 4096), dtype=np.int16)
        x[0, :L] = sig
        args = (torch.from_numpy(x).to(dev), [nd], 1024, 4, 1)
        got = kernels.bank_means(*args)[0, :nd]
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            want = build_domains_host(sig, 1024, 4, 1)
            walls.append((time.perf_counter() - t0) * 1e3)
        plain = kernels.bank_means_ref(*args)[0, :nd]
        if not (torch.equal(got, plain) and np.array_equal(
                got.cpu().numpy().view(np.uint32), want.view(np.uint32))):
            raise AssertionError(f"{key}: bank_means differs from the host build")
        host = torch.empty((nd, 4), dtype=torch.float32, pin_memory=True)
        check = {"rows": nd, "shape": [L, nd, 4], "max_abs_err": 0.0,
                 **bound({"bytes": (2 * L + 16 * nd) / HBM_BYTES_PER_S * 1e3}),
                 "copy_ms": cuda_ms(lambda: host.copy_(got, non_blocking=True)),
                 "host_build_ms": statistics.median(walls)}
        checks[key] = timed(check, lambda: kernels.bank_means(*args),
                            lambda: kernels.bank_means_ref(*args))


#: The refit kernel at the default geometry (4 taps): the same two files.
REFIT_CHECKS = [("refit_10s", 10.0), ("refit_94s", 94.0)]


def refit_kernel_checks(kernels, dev, checks):
    """collect_refit, in the variant models/refit.py's self-check picks,
    against its plain version (the native refit of the host path, every
    record byte and both counts) on the file's own records' codes, timed
    on the card alone (graph_ms), with its bytes bound (per range its code
    and record, per live range its samples and bank row, once); beside it
    the copy of its output into pinned host memory (CUDA events) and the
    native refit it replaces (models/refit.py collect_idx_matches on the
    float32 ranges and the host bank, host clock, median of 5)."""
    import numpy as np
    import torch

    from bench import make_signal
    from fwav_tpu_torch.models import encode as enc
    from fwav_tpu_torch.models import refit

    cfg = enc.EncoderConfig()
    n = cfg.range_size
    mode = refit.refit_mode(dev, n)  # raises where no variant gives the host's bits
    for key, seconds in REFIT_CHECKS:
        sig = make_signal(seconds)
        raw_p, nr, nd, lb, db = enc._prep_signal(sig, cfg)
        x = torch.from_numpy(raw_p[None]).to(dev)
        bank = kernels.bank_means(x, [nd], cfg.tile_size, n, cfg.domain_step)
        rng = np.random.default_rng(int(seconds))
        idx = rng.integers(0, nd, lb // n)
        idx[rng.random(len(idx)) < 0.08] = -1  # about a 10 s file's share of sentinels
        idx[nr:] = -1
        c3 = np.stack([(idx >> k) & 0xFF for k in (0, 8, 16)], -1).astype(np.uint8)
        codes = torch.from_numpy(c3[None]).to(dev)
        args = (codes, x, bank, [len(sig)], [nd], n, cfg.s_clip)
        got = kernels.collect_refit(*args, mode).cpu()
        plain = kernels.collect_refit_ref(*args)
        if not torch.equal(got, plain):
            raise AssertionError(f"{key}: collect_refit differs from the native refit")
        host_bank = bank[0, :nd].cpu().numpy()
        ranges = np.pad(sig, (0, nr * n - len(sig)), mode="reflect").reshape(nr, n)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            refit.collect_idx_matches(c3[:nr], nr, ranges, host_bank, cfg.s_clip)
            walls.append((time.perf_counter() - t0) * 1e3)
        live = int((idx >= 0).sum())
        host = torch.empty(got.shape, dtype=torch.uint8, pin_memory=True)
        out = kernels.collect_refit(*args, mode)
        check = {"ranges": nr, "live": live, "rows": nd, "mode": mode, "max_abs_err": 0.0,
                 "shape": [len(sig), nr, nd, n],
                 **bound({"bytes": (nr * (3 + 17) + live * 6 * n) / HBM_BYTES_PER_S * 1e3}),
                 "out_bytes": int(got.numel()),
                 "copy_ms": cuda_ms(lambda: host.copy_(out, non_blocking=True)),
                 "host_refit_ms": statistics.median(walls)}
        checks[key] = timed(check, lambda: kernels.collect_refit(*args, mode),
                            lambda: kernels.collect_refit_ref(*args), plain_reps=3,
                            plain_warmup=1, timer=graph_ms)


def staged_kernel_checks(port, kernels, enc, dev, checks):
    """K1 (balanced: one lobe) and K3 (damped: four) at the shapes the
    staged single-shot paths of STAGED give them: the bucketed ranges x the
    stride-subsampled rows of the full bank, at the path's taps per range
    (60 s: 786,432 x 24,576 x 4; tile 512: 114,688 x 7,168 x 4; tile 2048:
    57,344 x 1,792 x 8), each against its plain version on the card."""
    slow = {"plain_reps": 3, "plain_warmup": 1}
    for seed, (name, case) in enumerate(STAGED.items()):
        cfg = port.EncoderConfig(**case["kw"])
        n = cfg.range_size
        n_samples = int(case["seconds"] * 44100)
        mb = enc.bucket(-(-n_samples // n), 256)
        db = enc.bucket(enc.n_domains_for(n_samples, cfg.tile_size, cfg.domain_step), 256)
        mode, stride, refine = enc._plan_search(cfg, mb, db)
        if (mode, refine) != ("coarse", "staged"):
            raise AssertionError(f"staged {name}: the plan is {(mode, stride, refine)}")
        args = kernel_inputs(dev, 400 + seed, mb, db // stride, cfg.objective, N=n)
        if cfg.objective == "damped":
            checks[f"k3_staged_{name}"] = k3_check(
                kernels, f"K3 staged {name}", args, 16384, **slow)
        else:
            checks[f"k1_staged_{name}"] = k1_check(
                kernels, f"K1 staged {name}", args, False, 16384, **slow)


def k4_rows(lobes, n_valid, stride, per_lobe) -> int:
    """The bank rows K4 scores on these inputs: per live lobe of a pass,
    the descent's samples (W/16 + 1, then 5 where W >= 64; W/8 + 1 below)
    and its final window's rows under n_valid, or the dense window's rows
    under n_valid. Lobes of -1 and rows at or past n_valid are not scored.
    lobes (B, M, C) or (M, C); n_valid (B,)."""
    import torch

    W = max(2, stride + stride // 4)
    lobes = lobes if lobes.dim() == 3 else lobes[None]
    nv = n_valid.to(torch.int64).reshape(-1, 1, 1)
    live = lobes >= 0
    if stride >= 32 and (per_lobe or lobes.shape[2] == 1):
        w2 = (4 if W >= 64 else 8) + 2
        fixed = W // (16 if W >= 64 else 8) + 1 + (5 if W >= 64 else 0)
        rows = torch.where(live & (nv >= 1), fixed + nv.clamp(max=w2), 0)
    else:
        start = torch.minimum((lobes.to(torch.int64) * stride - W // 2).clamp(min=0),
                              (nv - W).clamp(min=0))
        rows = torch.where(live, (nv - start).clamp(0, W), 0)
    return int(rows.sum())


def k4_bound(ranges, bank, lobes, n_valid, stride, objective, per_lobe) -> dict:
    """K4's least time on these inputs: the scored rows' CUDA-core
    operations (3 per tap and K4_OPS_PER_ROW), their numerators on the
    tensor cores, or the bank, the ranges, the lobes and the counts read
    once and (idx, score) written once."""
    rows = k4_rows(lobes, n_valid, stride, per_lobe)
    N = int(ranges.shape[-1])
    nbytes = 4 * (bank.numel() + ranges.numel() + lobes.numel() + n_valid.numel()) \
        + 8 * (ranges.numel() // N)
    return {"scored_rows": rows, **bound({
        "cuda_core": rows * (3 * N + K4_OPS_PER_ROW[objective]) / CUDA_CORE_OPS_PER_S * 1e3,
        "tensor": numerator_ms(rows, N),
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    })}


def k4_design_bound(ranges, bank, lobes, n_valid, stride, objective, per_lobe,
                    table: bool) -> dict:
    """K4's least time as this design splits the work: the rows' terms
    once per bank row where it makes its table (else once per scored row)
    and the scoring per scored row (K4_TABLE_OPS_PER_ROW,
    K4_SCORE_OPS_PER_ROW), or the bank, ranges, lobes and counts read once,
    the table (4 floats a row) written and read once and (idx, score)
    written once."""
    rows = k4_rows(lobes, n_valid, stride, per_lobe)
    N = int(ranges.shape[-1])
    bank_rows = bank.numel() // N
    ops = (bank_rows if table else rows) * (3 * N + K4_TABLE_OPS_PER_ROW[objective]) \
        + rows * ((3 if table else 2) * N + K4_SCORE_OPS_PER_ROW[objective])
    nbytes = 4 * (bank.numel() + 2 * bank_rows * 4 * table + ranges.numel()
                  + lobes.numel() + n_valid.numel()) + 8 * (ranges.numel() // N)
    terms = {"cuda_core": ops / CUDA_CORE_OPS_PER_S * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"design_bound_ms": terms[term], "design_bound_term": term,
            "design_bound_terms_ms": terms}


def k4_stats_check(kernels, name, bank, objective, s_clip):
    """K4's per-row table against its plain version: equal bit for bit;
    timed as replayed CUDA graphs, with its bound: every row's operations
    (K4_TABLE_OPS_PER_ROW beside 3 a tap) or the bank read and the table
    written once."""
    import torch

    table = (bank, objective, s_clip)
    got, want = kernels.staged_stats(*table), kernels.staged_stats_ref(*table)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{name}: {int((got != want).sum())} table entries differ")
    N = int(bank.shape[-1])
    rows = bank.numel() // N
    check = {"rows": rows, "max_abs_err": 0.0, "shape": list(got.shape), **bound({
                 "cuda_core": rows * (3 * N + K4_TABLE_OPS_PER_ROW[objective])
                 / CUDA_CORE_OPS_PER_S * 1e3,
                 "bytes": 4 * (bank.numel() + got.numel()) / HBM_BYTES_PER_S * 1e3})}
    return timed(check, lambda: kernels.staged_stats(*table),
                 lambda: kernels.staged_stats_ref(*table), timer=graph_ms)


def k4_inputs(kernels, enc, dev, sig, cfg, stride, lb, db, n_domains, C, files=1):
    """K4's inputs as a staged path builds them from `sig`, at its buckets:
    the signal normalized (in a stack each file rolled by its own offset,
    its n_valid 1,000 rows under the previous file's), cut into lb // n
    ranges (the VAD mask left out), the full db-row bank zero from n_valid
    on, and the lobes of the path's scan over its stride-subsampled rows:
    K1's one (balanced) or K3's C (damped, and the global pass). Returns
    (ranges, bank, n_valid, lobes), a stack or, for one file, its file."""
    import numpy as np
    import torch

    from fwav_tpu_torch.ops.affine import affine_stats, row_mean
    from fwav_tpu_torch.ops.search import domain_thresh, domain_weights

    n = cfg.range_size
    x = np.zeros(enc.bucket(max(len(sig), lb), 4096), np.float32)
    x[: len(sig)] = sig / np.abs(sig).max()
    raw = torch.from_numpy(np.stack([np.roll(x, 4099 * b) for b in range(files)])).to(dev)
    nv = torch.tensor([n_domains - 1000 * b for b in range(files)], dtype=torch.int32,
                      device=dev)
    ranges = raw[:, :lb].reshape(files, lb // n, n).contiguous()
    bank = enc.build_bank(raw, cfg.tile_size, n, cfg.domain_step, db, nv.to(torch.int64))
    dc = db // stride
    bank_sub = bank.reshape(files, dc, stride, n)[:, :, 0, :]
    mean, denom = affine_stats(bank_sub)
    scan = (ranges - row_mean(ranges)[..., None], bank_sub.transpose(1, 2).contiguous(),
            domain_weights(mean, denom, n, cfg.objective),
            torch.arange(dc, device=dev)[None, :] * stride < nv[:, None])
    thresh = domain_thresh(denom, cfg.objective, cfg.s_clip)
    if C == 1:
        score, idx = kernels.search_scan(*scan, thresh, cfg.s_clip)
        lobes = torch.where(torch.isfinite(score), idx, -1)[..., None]
    else:
        lobes = kernels.topc_scan(*scan, C, thresh, cfg.s_clip)
    out = (ranges, bank, nv, lobes)
    return out if files > 1 else tuple(t[0] for t in out[:2]) + (nv, lobes[0])


def k4_score(kernels, ranges, bank, n_valid, lobes, stride, objective, s_clip, per_lobe,
             table):
    """K4's scoring launch alone, on `table` = kernels.staged_stats(bank,
    objective, s_clip) made before, through the kernel's C interface (the
    wrapper always makes its own): for timing the scoring apart from its
    table. A stack's arguments as kernels.staged_refine takes them; returns
    (idx, score)."""
    import ctypes

    import torch

    from fwav_tpu_torch.ops import _build

    if ranges.dim() == 2:
        idx, score = k4_score(kernels, ranges[None], bank[None], n_valid.reshape(1),
                              lobes[None], stride, objective, s_clip, per_lobe, table[None])
        return idx[0], score[0]
    B, M, N = ranges.shape
    idx = torch.empty((B, M), dtype=torch.int32, device=ranges.device)
    score = torch.empty((B, M), dtype=torch.float32, device=ranges.device)
    lib = _build.load()
    code = lib.fwav_staged_refine(
        ctypes.c_void_p(ranges.data_ptr()), B, M, N,
        ctypes.c_void_p(bank.data_ptr()), bank.shape[1], ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(lobes.data_ptr()), lobes.shape[2], lobes.stride(0), lobes.stride(1),
        lobes.stride(2), ctypes.c_void_p(n_valid.data_ptr()), stride,
        kernels._OBJECTIVES[objective], int(per_lobe), abs(float(s_clip)),
        ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(score.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, code, "staged_refine")
    return idx, score


def k4_check(kernels, name, args, stride, cfg, per_lobe=False, **plain_timing):
    """K4 against its plain version on the card: bit for bit (0 differing
    rows, 0 score error), timed as replayed CUDA graphs (graph_ms: the card
    alone) as the main paths call it (`ms`: with its table made in the
    call where staged_uses_table says it pays), and there the scoring on a
    table made before (`score_ms`, k4_score, bit for bit the whole call)
    and the table alone (`stats_ms`), with its bound on these inputs
    (k4_bound, the yardstick of the first design) and this design's own
    (k4_design_bound). Returns (K4's check, its table's, k4_stats_check at
    this bank, or None where no main path makes a table)."""
    import torch

    from fwav_tpu_torch.ops import near_tie

    ranges, bank, nv, lobes = args
    k4 = (*args, stride, cfg.objective, cfg.s_clip, per_lobe)
    got, want = kernels.staged_refine(*k4), kernels.staged_refine_ref(*k4)
    differ = int(((got[0] != want[0])
                  | (got[1].view(torch.int32) != want[1].view(torch.int32))).sum())
    check = near_tie.check_argmax(name, (got[1].reshape(-1), got[0].reshape(-1)),
                                  (want[1].reshape(-1), want[0].reshape(-1)))
    if differ or check["idx_diff"] or check["max_abs_err"]:
        raise AssertionError(f"{name}: {differ} rows differ from the plain version: {check}")
    check = {**check, "differing_rows": differ, "shape": [*lobes.shape, int(bank.shape[-2])],
             "N": int(ranges.shape[-1]), "stride": stride, "objective": cfg.objective,
             "per_lobe": per_lobe, **k4_bound(ranges, bank, lobes, nv, stride, cfg.objective,
                                               per_lobe)}
    uses = kernels.staged_uses_table(int(ranges.shape[-1]), stride, int(lobes.shape[-1]),
                                     per_lobe)
    check.update(uses_table=uses, **k4_design_bound(ranges, bank, lobes, nv, stride,
                                                    cfg.objective, per_lobe, uses))
    if uses:
        table = (bank, cfg.objective, cfg.s_clip)
        stats = kernels.staged_stats(*table)
        alone = k4_score(kernels, *k4, stats)
        if not (torch.equal(alone[0], got[0])
                and torch.equal(alone[1].view(torch.int32), got[1].view(torch.int32))):
            raise AssertionError(f"{name}: the scoring on a table made before differs")
        check.update(score_ms=graph_ms(lambda: k4_score(kernels, *k4, stats)),
                     stats_ms=graph_ms(lambda: kernels.staged_stats(*table)))
        del stats, alone
    out = timed(check, lambda: kernels.staged_refine(*k4),
                lambda: kernels.staged_refine_ref(*k4), timer=graph_ms, **plain_timing)
    out["design_share"] = out["design_bound_ms"] / out["ms"]
    return out, (k4_stats_check(kernels, f"{name} table", bank, cfg.objective, cfg.s_clip)
                 if uses else None)


#: K4 at the staged paths' shapes: (check, seconds of make_signal, config).
K4_CHECKS = [("k4_60s_balanced", 60.0, {}),
             ("k4_60s_damped", 60.0, {"objective": "damped"}),
             ("k4_tile512_balanced", 10.0, {"tile_size": 512}),
             ("k4_tile512_damped", 10.0, {"tile_size": 512, "objective": "damped"}),
             ("k4_tile2048_balanced", 10.0, {"tile_size": 2048}),
             ("k4_tile2048_damped", 10.0, {"tile_size": 2048, "objective": "damped"}),
             ("k4_tile8192_balanced", 10.0, {"tile_size": 8192}),
             ("k4_tile8192_damped", 10.0, {"tile_size": 8192, "objective": "damped"})]


def k4_shapes(port, kernels, enc, dev, stream_sig):
    """K4's inputs at the shapes of its main paths, as (check, (ranges,
    bank, n_valid, lobes), stride, config, per_lobe): the 100 s stream's
    global pass (1,310,720 ranges x 4 lobe columns, each its descent, over
    5,242,880 rows), the staged single-shot encodes of K4_CHECKS (60 s:
    786,432 x 1 lobe, the (16, 4) descent, and x 4 lobes, dense 4 x 160
    rows, over 3,145,728 rows; 10 s at tiles 512, 2048 and 8192, the last
    at 32 taps) and a stack of 16 ten-second files at tile 512 (damped)."""
    from bench import make_signal
    from fwav_tpu_torch.models.stream import GLOBAL_NOM_ROWS

    # the global pass, as models/stream.py _global_pass sizes it
    cfg = port.EncoderConfig(objective="damped")
    n = cfg.range_size
    m = -(-len(stream_sig) // n)
    d_total = enc.n_domains_for(len(stream_sig), cfg.tile_size, cfg.domain_step)
    stride = cfg.global_stride
    while -(-d_total // stride) > GLOBAL_NOM_ROWS:
        stride *= 2
    lb, db = enc.bucket(m, 256) * n, enc.bucket(-(-d_total // stride), 16) * stride
    yield ("k4_global_pass", k4_inputs(kernels, enc, dev, stream_sig, cfg, stride, lb, db,
                                       d_total, cfg.global_topc), stride, cfg, True)
    signals = {}
    for key, seconds, kw in K4_CHECKS:
        sig = signals.setdefault(seconds, make_signal(seconds))
        cfg = port.EncoderConfig(**kw)
        _, _, nd, lb, db = enc._prep_signal(sig, cfg)
        mode, stride, refine = enc._plan_search(cfg, lb // cfg.range_size, db)
        if (mode, refine) != ("coarse", "staged"):
            raise AssertionError(f"{key}: the plan is {(mode, stride, refine)}")
        yield (key, k4_inputs(kernels, enc, dev, sig, cfg, stride, lb, db, nd,
                              enc._coarse_topc(cfg)), stride, cfg, False)
    cfg = port.EncoderConfig(tile_size=512, objective="damped")
    sig = signals[10.0]
    _, _, nd, lb, db = enc._prep_signal(sig, cfg)
    stride = enc._plan_search(cfg, lb // cfg.range_size, db)[1]
    yield ("k4_stack16_tile512_damped", k4_inputs(kernels, enc, dev, sig, cfg, stride, lb, db,
                                                  nd, 4, files=PACK_FILES), stride, cfg, False)


def staged_refine_checks(port, kernels, enc, dev, stream_sig, checks):
    """K4 and its table against their plain versions on the card at the
    shapes of k4_shapes; every file of the stack of 16 equals its single
    launch bit for bit. Checks k4_* (K4) and ks_* (its table)."""
    import torch

    for key, args, stride, cfg, per_lobe in k4_shapes(port, kernels, enc, dev, stream_sig):
        slow = {"plain_reps": 2 if per_lobe else 3, "plain_warmup": 1}
        checks[key], table = k4_check(kernels, key, args, stride, cfg, per_lobe, **slow)
        if table is not None:
            checks["ks_" + key[3:]] = table
        if not key.startswith("k4_stack16"):
            continue
        # one launch over the stack: each file its single launch
        ranges, bank, nv, lobes = args
        geo = (stride, cfg.objective, cfg.s_clip)
        got = kernels.staged_refine(ranges, bank, nv, lobes, *geo)
        for b in range(PACK_FILES):
            one = kernels.staged_refine(ranges[b], bank[b], nv[b : b + 1], lobes[b], *geo)
            if not (torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])):
                raise AssertionError(f"K4 stack of 16: file {b} differs from its single launch")
        for prefix, fn in (
                ("k4_", lambda: kernels.staged_refine(ranges[0], bank[0], nv[:1], lobes[0],
                                                      *geo)),
                ("ks_", lambda: kernels.staged_stats(bank[0], *geo[1:]))):
            check = checks[prefix + key[3:]]
            single_ms = graph_ms(fn)
            check.update(files=PACK_FILES, single_launch_ms=single_ms,
                         stack_over_singles=check["ms"] / (PACK_FILES * single_ms))


def mesh_kernel_checks(kernels, enc, dev, sig, stream_sig, checks):
    """K1, K3 and K2 at the shapes a cell of mesh_phase's meshes gives
    them, each against its plain version on the card with no differing row
    and no score error: a coarse cell's range sub-slab of the 10 s file
    at (2, 1) and (1, 2) (57,344 ranges) and at (2, 2) and (4, 1) (28,672)
    against its 3,584 subsampled rows, and of a 100 s stream shard at
    (2, 2) (65,536 x 12,288); the 0.5 s exact clip's bank row shards at
    tp 2 and 4 (6,144 ranges x 12,288 or 6,144 rows, the last shard's
    valid rows cut to 8,739 and 2,595, and a shard with none, as a shorter
    file leaves one); and one cell's share of the packed 16-file stack
    over 4 cells (4 files of 114,688 ranges). The scan's domain split
    (search_scan's n_split) follows the ranges of a launch, so these shapes
    may run split configurations that the single-device shapes do not."""
    import numpy as np
    import torch

    from fwav_tpu_torch.ops import near_tie

    slow = {"plain_reps": 3, "plain_warmup": 1}

    def zero(key, check):
        if check["idx_diff"] or check["max_abs_err"]:
            raise AssertionError(f"{key}: the kernel and its plain version differ: {check}")
        checks[key] = check

    def k2_case(key, name, means_ext, lobes, ranges, n_valid, objective):
        k2 = (means_ext, lobes, ranges, n_valid, 128, 256, objective, 16.0)
        zero(key, k2_check(kernels, name, k2, **slow))

    def window_means(x, nbw, dc):
        win = x[:nbw]
        raw_norm = torch.from_numpy(win / np.abs(win).max()).to(dev)
        return enc._means_setup(raw_norm, 4, 256, 128, dc)[0]

    # coarse range sub-slabs: (ranges, subsampled rows, K2's n_valid, means)
    means10 = window_means(sig, len(sig), 3584)
    means_shard = window_means(stream_sig, 1572864, 12288)
    for seed, (tag, M, D, n_valid, means) in enumerate((
            ("10s_cell2", 57344, 3584, 439977, means10),
            ("10s_cell4", 28672, 3584, 439977, means10),
            ("stream_cell4", 65536, 12288, 1572864 - 1024 + 1, means_shard))):
        rblk = enc._pow2_divisor(M, 16384)
        zero(f"k1_mesh_{tag}", k1_check(kernels, f"K1 mesh {tag}",
                                        kernel_inputs(dev, 500 + seed, M, D, "balanced"),
                                        False, rblk, **slow))
        zero(f"k3_mesh_{tag}", k3_check(kernels, f"K3 mesh {tag}",
                                        kernel_inputs(dev, 510 + seed, M, D, "damped"),
                                        rblk, **slow))
        rng = np.random.default_rng(520 + seed)
        ranges = torch.from_numpy(rng.standard_normal((M, 4)).astype(np.float32) * 0.3).to(dev)
        lobes = torch.from_numpy(rng.integers(-1, D - 3, M).astype(np.int32)).to(dev)
        k2_case(f"k2_mesh_{tag}", f"K2 mesh {tag}", means, lobes, ranges, n_valid,
                "balanced")
        lobes4 = k2_lobe_matrix(kernels, dev, 530 + seed, M, D, "damped", n_valid, 128)
        k2_case(f"k2_mesh_lobes4_{tag}", f"K2 4 lobes mesh {tag}", means, lobes4, ranges,
                n_valid, "damped")

    # exact: each tp cell's bank row shard, its valid rows as the clip's
    for tp, shard_valid in ((2, (12288, 8739)), (4, (6144, 2595, 0))):
        D = 24576 // tp
        for j, nv in enumerate(shard_valid):
            args = list(kernel_inputs(dev, 540 + 4 * tp + j, 6144, D, "balanced"))
            args[3] = torch.arange(D, device=dev) < nv
            zero(f"k1_mesh_exact_tp{tp}_valid{nv}",
                 k1_check(kernels, f"K1 mesh exact tp {tp}, {nv} valid rows", tuple(args),
                          False, 2048, **slow))

    # one cell's share of the packed stack: 4 files in one launch
    B, M, D = PACK_FILES // 4, 114688, 3584
    files = [kernel_inputs(dev, 560 + b, M, D, "balanced") for b in range(B)]
    st = [torch.stack([f[k] for f in files]) for k in range(4)]
    check = {**near_tie.check_argmax("K1 mesh packed share",
                                     [x.reshape(-1) for x in kernels.search_scan(*st)],
                                     [x.reshape(-1) for x in kernels.search_scan_ref(
                                         *st, range_block=16384)]),
             "shape": [B, M, D], **scan_bound(M, 4, int(st[3].sum()), D, 8, False, files=B)}
    zero("k1_mesh_packed_share", timed(
        check, lambda: kernels.search_scan(*st),
        lambda: kernels.search_scan_ref(*st, range_block=16384), **slow))
    n_valid = [439977 - 1000 * b for b in range(B)]
    raw = np.stack([np.roll(sig, 4099 * b) for b in range(B)])
    means_ext = enc._means_setup(torch.from_numpy(raw / np.abs(sig).max()).to(dev), 4, 256,
                                 128, D)[0]
    rng = np.random.default_rng(570)
    ranges = torch.from_numpy(rng.standard_normal((B, M, 4)).astype(np.float32) * 0.3).to(dev)
    lobes = torch.from_numpy(rng.integers(-1, D - 3, (B, M)).astype(np.int32)).to(dev)
    geo = (128, 256, "balanced", 16.0)
    check = near_tie.check_argmax(
        "K2 mesh packed share",
        [x.reshape(-1) for x in kernels.refine_window(means_ext, lobes, ranges, n_valid, *geo)],
        [x.reshape(-1) for x in kernels.refine_window_ref(means_ext, lobes, ranges, n_valid,
                                                           *geo)])
    check = {**check, "shape": [*lobes.shape, int(means_ext.shape[1])],
             **stack_refine_bound(lobes, 4, int(means_ext.shape[1]), "balanced", 128)}
    n_valid = device_counts(n_valid, dev)
    zero("k2_mesh_packed_share", timed(
        check, lambda: kernels.refine_window(means_ext, lobes, ranges, n_valid, *geo),
        lambda: kernels.refine_window_ref(means_ext, lobes, ranges, n_valid, *geo),
        timer=graph_ms, **slow))


def stream_run(port, kernels, sig, reps, **kw):
    """compress_audio_streaming on the card `reps` times; the first run's
    launches, its result and stats; host-clock seconds of every run."""
    times, out = [], None
    for i in range(reps):
        stats = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.compress_audio_streaming(sig, 44100, 2, device="cuda", stats=stats, **kw)
        times.append(time.perf_counter() - t0)
        if i == 0:
            out = (res, dict(kernels.LAUNCHES), stats)
    return (*out, times)


def stream_damped_decode(port, tmp, name, sig, res, device="cuda"):
    """The streaming prune, v2 with the decode hint, load, and the decode
    loop at the stored hint: (SNR, loop stats, bytes, the decode's args)."""
    import numpy as np

    from fwav_tpu_torch.models.stream import _prune_streamed

    rec, _, _, rs, tile, step, thr, olen = res
    prec, bank = _prune_streamed(rec, sig, tile, rs, step)
    path = Path(tmp) / f"{name}.fwav"
    port.save_compressed_compact(path, prec, bank, rs, 44100, 2, tile, step, thr, olen,
                                 decode_damping=port.DAMPED_DECODE_DAMPING)
    hint = port.parse_decode_hint(path.read_bytes()[:128])
    if hint != port.DAMPED_DECODE_DAMPING:
        raise AssertionError(f"{name}: the decode hint read back is {hint}")
    lrec, lbank, ln, lrs, *_, lolen = port.load_compressed_arrays(path)
    args = dict(matches=lrec, domains_array=lbank, n_ranges=ln, range_size=lrs,
                original_len=lolen, s_damping=hint, device=device)
    stats = {}
    recon = port.decompress_audio(**args, stats=stats)
    if not np.isfinite(recon).all() or recon.shape != sig.shape:
        raise AssertionError(f"{name}: the decode is not finite or has the wrong length")
    return port.compute_snr(sig, recon), stats, path.stat().st_size, args


def stream_profile(port, sig, **kw):
    """One 100 s streaming encode under torch.profiler: its result, and the
    card's busy time beside the profiled run's host-clock seconds. The
    kernels launched through ctypes are not attributed to the `phase.*`
    ranges, so a phase's busy time is taken as the difference of two
    encodes."""
    res, device_ms, wall, events, _, lost = busy_ms(
        lambda: port.compress_audio_streaming(sig, 44100, 2, device="cuda", **kw))
    return res, {"profiled_wall_s": wall, "device_events": events, "device_ms": device_ms,
                 "records_lost": lost}


def stream_phase(port, kernels, smi, sig):
    """The 100 s streaming paths on the card, held to the JAX CPU run's
    numbers; then the 12 s fixture against the host's plain run. Returns
    the launch counts of both 100 s paths."""
    import numpy as np
    import torch

    from bench import make_signal
    from fwav_tpu_torch.models.stream import domain_block_iter
    from fwav_tpu_torch.ops.domains import n_domains_for

    seconds = len(sig) / 44100
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        res, launches, stats, times = stream_run(port, kernels, sig, 3, objective="damped")
        peak = torch.cuda.max_memory_allocated() / 2**20
        if launches["topc_scan"] < 6 or min(launches["refine_window"],
                                            launches["window_stats"]) < 5 or (
                launches["staged_refine"] != 1 or launches["staged_stats"]):
            # the pass's descents score without K4's table (staged_uses_table)
            raise AssertionError(f"the damped stream did not launch K3 x6, K2 x5 and K4 once "
                                 f"(its pass, no table): {launches}")
        sentinels = int((res[0]["idx"] < 0).sum())
        if res[2] != STREAM_RANGES or sentinels != STREAM_SENTINELS:
            raise AssertionError(f"damped stream: {sentinels} sentinels in {res[2]} ranges")
        snr, dstats, size, dargs = stream_damped_decode(port, tmp, "damped", sig, res)
        if abs(snr - STREAM_DAMPED_SNR_DB) > SNR_TOL_DB:
            raise AssertionError(f"damped stream SNR {snr} dB, expected "
                                 f"{STREAM_DAMPED_SNR_DB} +/- {SNR_TOL_DB}")
        if dstats["iterations"] != STREAM_DAMPED_ITERATIONS or not dstats["converged"]:
            raise AssertionError(f"damped stream: the decode loop stopped with {dstats}")
        if abs(size - STREAM_DAMPED_COMPACT_BYTES_JAX) > STREAM_DAMPED_COMPACT_BYTES_JAX // 1000:
            raise AssertionError(f"damped stream: {size} B, the JAX run {STREAM_DAMPED_COMPACT_BYTES_JAX}")
        decode_ms = cuda_ms(lambda: port.decompress_audio(**dargs), reps=3, warmup=1)
        prof = stream_profile(port, sig, objective="damped")[1]
        off, prof_off = stream_profile(port, sig, objective="damped", global_candidates=False)
        prof = {**prof, "without_pass": prof_off,
                "global_pass_device_ms": prof["device_ms"] - prof_off["device_ms"],
                "global_pass_device_events": prof["device_events"] - prof_off["device_events"]}
        snr_off = stream_damped_decode(port, tmp, "damped_off", sig, off)[0]
        if snr - snr_off <= 3.0:
            raise AssertionError(f"the global pass gained {snr - snr_off} dB, not > 3")
        if abs(snr_off - STREAM_DAMPED_OFF_SNR_DB) > SNR_TOL_DB:
            raise AssertionError(f"damped stream without the pass: {snr_off} dB, expected "
                                 f"{STREAM_DAMPED_OFF_SNR_DB} +/- {SNR_TOL_DB}")
        out["stream_damped"] = launches
        emit({"phase": "stream_damped", "card": smi, "seconds_audio": seconds,
              "n_ranges": res[2], "sentinels": sentinels, "snr_db": snr,
              "snr_without_pass_db": snr_off, "decode_stats": dstats,
              "compact_bytes": size, "compact_bytes_jax_cpu": STREAM_DAMPED_COMPACT_BYTES_JAX,
              "launches": launches, "encode_s": times,
              "x_realtime": seconds / statistics.median(times),
              "decode_ms_median3": decode_ms, "peak_mem_mb": peak, "stats": stats,
              "profile": prof})

        torch.cuda.reset_peak_memory_stats()
        res, launches, stats, times = stream_run(port, kernels, sig, 3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if min(launches[k] for k in ("search_scan", "refine_window", "window_stats")) < 5 or (
                launches["staged_refine"] or launches["staged_stats"]):
            raise AssertionError(f"the balanced stream did not launch K1 x5 and K2 x5 (and no "
                                 f"K4): {launches}")
        rec, _, n_ranges, rs, tile, step, thr, olen = res
        sentinels = int((rec["idx"] < 0).sum())
        if n_ranges != STREAM_RANGES or sentinels != STREAM_SENTINELS:
            raise AssertionError(f"balanced stream: {sentinels} sentinels in {n_ranges} ranges")
        path = Path(tmp) / "balanced.fwav"
        port.save_compressed_streaming(path, rec, domain_block_iter(sig, tile, rs, step),
                                       n_domains_for(olen, tile, step), rs, 44100, 2, tile,
                                       step, thr, olen)
        lrec, lbank, ln, lrs, *_, lolen = port.load_compressed_arrays(path)
        recon = port.decompress_audio(lrec, lbank, ln, lrs, original_len=lolen, device="cuda")
        snr = port.compute_snr(sig, recon)
        if not np.isfinite(recon).all() or recon.shape != sig.shape:
            raise AssertionError("balanced stream: the decode is not finite or has the wrong length")
        if abs(snr - STREAM_BALANCED_SNR_DB) > SNR_TOL_DB:
            raise AssertionError(f"balanced stream SNR {snr} dB, expected "
                                 f"{STREAM_BALANCED_SNR_DB} +/- {SNR_TOL_DB}")
        if path.stat().st_size != STREAM_BALANCED_V1_BYTES:
            raise AssertionError(f"balanced stream: {path.stat().st_size} B of v1")
        out["stream_balanced"] = launches
        emit({"phase": "stream_balanced", "card": smi, "seconds_audio": seconds,
              "n_ranges": n_ranges, "sentinels": sentinels, "snr_db": snr,
              "v1_bytes": path.stat().st_size, "launches": launches, "encode_s": times,
              "x_realtime": seconds / statistics.median(times), "peak_mem_mb": peak,
              "stats": stats, "profile": stream_profile(port, sig)[1]})

    # the 12 s fixture of tests/test_torch_stream.py: card against host
    mid = make_signal(12.0)
    for objective in ("balanced", "damped"):
        kw = dict(shard_samples=1 << 17, halo=1 << 15, objective=objective)
        gpu = port.compress_audio_streaming(mid, 44100, 2, device="cuda", **kw)[0]
        cpu = port.compress_audio_streaming(mid, 44100, 2, device="cpu", **kw)[0]
        if not np.array_equal(gpu["idx"] < 0, cpu["idx"] < 0):
            raise AssertionError(f"stream mid {objective}: the sentinel sets differ")
        diff = int((gpu["idx"] != cpu["idx"]).sum())
        if diff > 2 * -(-len(cpu) // 1024):
            raise AssertionError(f"stream mid {objective}: {diff} idx differ")
        emit({"phase": "stream_mid", "objective": objective, "n_ranges": len(cpu),
              "idx_diff_vs_host": diff})
    return out


#: Files of one stack in the packed phases (fwav_tpu_torch PACK_B_MAX).
PACK_FILES = 16


def stack_kernel_checks(kernels, enc, dev, sig, checks):
    """A stack of PACK_FILES files in one launch of each kernel: equal bit
    for bit to the single launches, held to the plain versions' loop over
    the files (0 differing rows), timed, with the bound of all its files."""
    import numpy as np
    import torch

    from fwav_tpu_torch.ops import near_tie

    B = PACK_FILES
    slow = {"plain_reps": 3, "plain_warmup": 1}

    def scan_files(seed, M, D, objective):
        """Per-file scan inputs, each file's valid prefix of its own
        length, and the same with a leading file axis."""
        files = []
        for b in range(B):
            f = list(kernel_inputs(dev, seed + b, M, D, objective))
            f[3] = torch.arange(D, device=dev) < D - 37 - 11 * b
            files.append(f)
        stack = [None if files[0][k] is None else torch.stack([f[k] for f in files])
                 for k in range(5)]
        return files, stack

    def same_as_singles(name, got, singles):
        for b, one in enumerate(singles):
            for g, o in zip(got, one):
                if not torch.equal(g[b], o):
                    raise AssertionError(f"{name}: file {b} of the stack differs from "
                                         "its single launch")

    def stack_numbers(check, name, fn, single_fn, plain_fn, timer=kernel_ms, **plain_timing):
        if check["idx_diff"]:
            raise AssertionError(f"{name}: {check['idx_diff']} rows differ from the plain "
                                 "version")
        single_ms = timer(single_fn)
        out = timed(check, fn, plain_fn, timer=timer, **plain_timing)
        return {**out, "files": B, "single_launch_ms": single_ms,
                "stack_over_singles": out["ms"] / (B * single_ms)}

    def k1_stack(key, name, seed, M, D, objective, range_block):
        clip = objective == "damped"
        files, st = scan_files(seed, M, D, objective)
        kw = {"s_clip": 16.0} if clip else {}
        cut = (lambda a: a) if clip else (lambda a: a[:4])
        got = kernels.search_scan(*cut(st), **kw)
        same_as_singles(name, got, [kernels.search_scan(*cut(f), **kw) for f in files])
        want = kernels.search_scan_ref(*cut(st), **kw, range_block=range_block)
        check = {**near_tie.check_argmax(name, [x.reshape(-1) for x in got],
                                         [x.reshape(-1) for x in want]),
                 "shape": [B, M, D],
                 **scan_bound(M, 4, int(st[3].sum()), D, 8, clip, files=B)}
        checks[key] = stack_numbers(
            check, name, lambda: kernels.search_scan(*cut(st), **kw),
            lambda: kernels.search_scan(*cut(files[0]), **kw),
            lambda: kernels.search_scan_ref(*cut(st), **kw, range_block=range_block), **slow)

    M, D = 114688, 3584
    k1_stack("k1_stack16_balanced", "K1 stack of 16", 100, M, D, "balanced", 16384)
    k1_stack("k1_stack16_exact_damped", "K1 exact damped stack of 16", 120, 8192, 24576,
             "damped", 8192)

    # K3, damped, C = 4
    files, st = scan_files(140, M, D, "damped")

    def k3(a):  # topc_scan's arguments: C = 4, s_clip 16
        return (a[0], a[1], a[2], a[3], 4, a[4], 16.0)

    lists = kernels.topc_scan(*k3(st))
    same_as_singles("K3 stack of 16", (lists,), [(kernels.topc_scan(*k3(f)),) for f in files])
    want = kernels.topc_scan_ref(*k3(st), range_block=16384)

    def gain(idx, rows):  # float64 gains of lists on rows of the flattened stack
        out = np.empty(idx.shape, np.float64)
        for b in np.unique(rows // M):
            at = np.nonzero(rows // M == b)[0]
            r_c, bank_t, w, _, thresh = (x.cpu().numpy() for x in files[b])
            out[at] = near_tie.topc_gain64(r_c[rows[at] % M], bank_t, w, thresh, 16.0, idx[at])
        return out

    check = {**near_tie.check_lists("K3 stack of 16", lists.reshape(B * M, 4),
                                    want.reshape(B * M, 4), gain),
             "shape": [B, M, D, 4], **scan_bound(M, 4, int(st[3].sum()), D, 16, True, files=B)}
    checks["k3_stack16_damped"] = stack_numbers(
        check, "K3 stack of 16", lambda: kernels.topc_scan(*k3(st)),
        lambda: kernels.topc_scan(*k3(files[0])),
        lambda: kernels.topc_scan_ref(*k3(st), range_block=16384), **slow)

    # K2 and its table: each file's box means are the 10 s signal rolled by
    # its own offset; n_valid differs per file
    stride, block_len = 128, 256
    n_valid = [439977 - 1000 * b for b in range(B)]
    raw = np.stack([np.roll(sig, 4099 * b) for b in range(B)])
    raw_norm = torch.from_numpy(raw / np.abs(sig).max()).to(dev)
    means_ext, _ = enc._means_setup(raw_norm, 4, block_len, stride, D)
    L = int(means_ext.shape[1])
    rng = np.random.default_rng(8)
    ranges = torch.from_numpy(rng.standard_normal((B, M, 4)).astype(np.float32) * 0.3).to(dev)
    lobes1 = torch.from_numpy(rng.integers(-1, D - 3, (B, M)).astype(np.int32)).to(dev)
    lobes4 = lists  # (B, M, 4), K3's layout: the view of its (B, 4, M) output
    lobes4[:, ::97] = -1
    lobes4[:, 1::53, 2:] = -1
    lobes4[:, 2::31, 3] = lobes4[:, 2::31, 0]
    for key, name, lobes, objective in (
            ("k2_stack16_balanced", "K2 stack of 16", lobes1, "balanced"),
            ("k2_stack16_lobes4_damped", "K2 4 lobes stack of 16", lobes4, "damped")):
        geo = (stride, block_len, objective, 16.0)
        got = kernels.refine_window(means_ext, lobes, ranges, n_valid, *geo)
        same_as_singles(name, got, [
            kernels.refine_window(means_ext[b], lobes[b], ranges[b], n_valid[b], *geo)
            for b in range(B)])
        want = kernels.refine_window_ref(means_ext, lobes, ranges, n_valid, *geo)
        check = near_tie.check_argmax(name, [x.reshape(-1) for x in got],
                                      [x.reshape(-1) for x in want])
        if check["max_abs_err"]:
            raise AssertionError(f"{name}: scores differ from the plain version: {check}")
        check = {**check, "shape": [*lobes.shape, L],
                 **stack_refine_bound(lobes, 4, L, objective, stride)}
        nv = device_counts(n_valid, dev)
        checks[key] = stack_numbers(
            check, name,
            lambda: kernels.refine_window(means_ext, lobes, ranges, nv, *geo),
            lambda: kernels.refine_window(means_ext[0], lobes[0], ranges[0], nv[:1], *geo),
            lambda: kernels.refine_window_ref(means_ext, lobes, ranges, nv, *geo),
            timer=graph_ms, **slow)
        table = kernels.window_stats(means_ext, 4, block_len, objective)
        if not torch.equal(table, kernels.window_stats_ref(means_ext, 4, block_len, objective)):
            raise AssertionError(f"{name}: the stack's table differs from the plain version")
        same_as_singles(name + " table", (table,), [
            (kernels.window_stats(means_ext[b], 4, block_len, objective),) for b in range(B)])
        bnd = stats_bound(4, L, objective)
        terms = {k: v * B for k, v in bnd["bound_terms_ms"].items()}
        check = {"rows": B * L, "idx_diff": 0, "max_abs_err": 0.0, "shape": [B, L],
                 **bound(terms)}
        checks[key.replace("k2_", "ws_")] = stack_numbers(
            check, name + " table",
            lambda: kernels.window_stats(means_ext, 4, block_len, objective),
            lambda: kernels.window_stats(means_ext[0], 4, block_len, objective),
            lambda: kernels.window_stats_ref(means_ext, 4, block_len, objective),
            timer=graph_ms)


def packed_signals(seconds, count, seed0=0):
    """`count` files of one length: bench.make_signal scaled by a seeded
    gain in [0.6, 1) and dithered with seeded noise (std 20 of the 16-bit
    scale), rounded, so that each is 16-bit content of its own."""
    import numpy as np

    from bench import make_signal

    base = make_signal(seconds)
    out = []
    for k in range(count):
        rng = np.random.default_rng(seed0 + k)
        gain = 0.6 + 0.4 * rng.random()
        out.append(np.round(base * gain + rng.normal(0, 20, len(base))).astype(np.float32))
    return out


#: Prefixes of the port's profiler ranges (record_function): the phases of
#: fwav_tpu_torch/utils/trace.py. A range also shows on the card's side of
#: a trace as an annotation over the kernels it encloses, so it is no work
#: of its own.
USER_RANGES = ("phase.",)


#: Host calls that put the card's work in a trace: kernel launches, copies
#: and memsets. Each record of that work carries its call's correlation id.
DEVICE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")
#: A replayed program's one host call (fwav_tpu_torch/models/program.py):
#: every kernel, copy and memset node of the graph leaves a record with its
#: correlation id, so it counts as that many calls.
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")

#: Seconds for which `padded` keeps the card working (a one-element add and
#: a sync every PROFILE_PROBE_S) before the profiled block. On the card the
#: profiler lost the first records of a block (its uploads and first
#: kernels: 1-21 of a 10 s encode's 244) when the card had sat idle at the
#: start of the window, and none in 16 windows that began with this warm-up.
PROFILE_WARM_S = 0.3
PROFILE_PROBE_S = 0.005


@contextlib.contextmanager
def padded(prof_cm):
    """Enter the torch.profiler context `prof_cm`, keep the card working
    for PROFILE_WARM_S, then run the block and synchronize. Yields
    (the profiler, time.time_ns() at the block's start): device_work counts
    the block's own work from that time on, not the warm-up's."""
    import torch

    x = torch.zeros(1, device="cuda")
    with prof_cm as prof:
        t = time.perf_counter()
        while time.perf_counter() - t < PROFILE_WARM_S:
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PROBE_S)
        yield prof, time.time_ns()
        torch.cuda.synchronize()


def device_events(prof):
    """The card's kernels and copies of a torch.profiler run: its CUDA-side
    events but the annotations of USER_RANGES."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith(USER_RANGES)]


def program_replays():
    """(programs captured so far, {key: (replays, work nodes)}) of the
    process's program cache (fwav_tpu_torch/models/program.py): the work
    nodes are a graph's kernel, copy and memset nodes."""
    from fwav_tpu_torch.models.program import PROGRAMS

    st = PROGRAMS.stats()
    return st["captures"], {
        repr(p["key"]): (p["replays"], sum(p["nodes"].get(k, 0)
                                           for k in ("kernel", "copy", "memset")))
        for p in st["programs"]}


@contextlib.contextmanager
def counted_replays():
    """Yields a dict that receives, after the block, the graph launches the
    block made ("launches") and the records they owe ("nodes"); raises if a
    program was captured inside it (a capture's calls leave no record:
    warm every program before a profiled block)."""
    caps0, before = program_replays()
    out = {}
    yield out
    caps1, after = program_replays()
    if caps1 != caps0:
        raise AssertionError("a program was captured inside a profiled block")
    delta = {k: r - before.get(k, (0, 0))[0] for k, (r, _) in after.items()}
    out["launches"] = sum(delta.values())
    out["nodes"] = sum(d * after[k][1] for k, d in delta.items())


def device_work(prof, since_ns, graphs=None):
    """The card's work that host calls made from `since_ns` on put in a
    torch.profiler trace, found by correlation id: (its records, the
    annotations of USER_RANGES left out; the count of those calls, a graph
    launch counting as its graph's work nodes; the count of them that left
    no record, which the profiler lost). `graphs` is counted_replays' dict
    of the block; the trace must show as many graph launches."""
    from torch.autograd import DeviceType

    graphs = graphs or {"launches": 0, "nodes": 0}
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA
            and e.name().startswith(DEVICE_CALLS + GRAPH_LAUNCHES) and e.start_ns() >= since_ns]
    launched = {e.correlation_id() for e in host if e.name().startswith(GRAPH_LAUNCHES)}
    if len(launched) != graphs["launches"]:
        raise AssertionError(f"the trace shows {len(launched)} graph launches, the program "
                             f"cache {graphs['launches']} replays")
    calls = {e.correlation_id() for e in host}
    recs = [e for e in events if e.device_type() == DeviceType.CUDA
            and e.correlation_id() in calls and not e.name().startswith(USER_RANGES)]
    plain = calls - launched
    from_graphs = sum(e.correlation_id() in launched for e in recs)
    lost = len(plain - {e.correlation_id() for e in recs}) + graphs["nodes"] - from_graphs
    return recs, len(plain) + graphs["nodes"], lost


def busy_ms(fn):
    """fn() under torch.profiler (padded): (its result, the card's busy
    time as the summed durations of fn's kernels, copies and memsets in ms,
    host-clock seconds, the count of those records, the count of fn's host
    calls that put work on the card (a replayed program's graph launch
    counting as its graph's work nodes), the count of those the profiler
    lost)."""
    from torch.profiler import ProfilerActivity, profile

    with counted_replays() as graphs:
        with padded(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) as (
                prof, ns):
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
    recs, calls, lost = device_work(prof, ns, graphs)
    return res, sum(e.duration_ns() for e in recs) / 1e6, wall, len(recs), calls, lost


def same_result(a, b) -> bool:
    """Two compress_audio_arrays-shaped results: records, bank and header
    equal exactly."""
    import numpy as np

    return (np.array_equal(a[0].view(np.uint8), b[0].view(np.uint8))
            and np.array_equal(a[1], b[1]) and tuple(a[2:]) == tuple(b[2:]))


def packed_phase(port, kernels, enc, smi):
    """compress_audio_packed on the card against the single-file encodes;
    returns the launch counts of its three paths."""
    import torch

    from fwav_tpu_torch.ops.domains import build_domains_host

    out = {}
    ten = packed_signals(10.0, PACK_FILES)
    cases = [("packed_balanced", ten + packed_signals(7.0, 1, seed0=99), {}, "search_scan", 2),
             ("packed_damped", ten + packed_signals(7.0, 1, seed0=99),
              {"objective": "damped"}, "topc_scan", 2),
             ("packed_exact", packed_signals(0.5, PACK_FILES, seed0=200), {}, "search_scan", 1),
             # a stack whose refine is the staged one: K3, then K4, once each per stack
             ("packed_staged", ten + packed_signals(7.0, 1, seed0=99),
              {"tile_size": 512, "objective": "damped"}, "topc_scan", 2)]
    for phase, sigs, kw, scan, stacks in cases:
        cfg = port.EncoderConfig(**kw)
        _, _, _, lb, db = enc._prep_signal(sigs[0], cfg)
        plan = enc._plan_search(cfg, lb // cfg.range_size, db)
        port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)  # warm
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        packed = port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        k2 = stacks if plan[2] == "window" else 0
        if (plan[2] == "staged") != (phase == "packed_staged"):
            raise AssertionError(f"{phase}: the plan is {plan}")
        want = {**dict.fromkeys(launches, 0), scan: stacks, "refine_window": k2,
                "window_stats": k2, "bank_means": stacks, "collect_refit": stacks,
                "staged_refine": stacks if plan[2] == "staged" else 0,
                "staged_stats": stacks if plan[2] == "staged" and kernels.staged_uses_table(
                    cfg.range_size, plan[1], enc._coarse_topc(cfg), False) else 0}
        if launches != want:
            raise AssertionError(f"{phase}: launches {launches}, expected one of each kernel "
                                 f"per stack: {want}")
        singles = [port.compress_audio_arrays(s, 44100, 2, device="cuda", **kw) for s in sigs]
        differ = [i for i, (a, b) in enumerate(zip(packed, singles)) if not same_result(a, b)]
        if differ:
            raise AssertionError(f"{phase}: files {differ} differ from their single encodes")
        live = sum(int((r[0]["idx"] >= 0).sum()) for r in packed)
        if not live:
            raise AssertionError(f"{phase}: no live range")
        stack = sigs[:PACK_FILES]
        stack_s, single_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            port.compress_audio_packed(stack, 44100, 2, device="cuda", **kw)
            stack_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for sg in stack:
                port.compress_audio_arrays(sg, 44100, 2, device="cuda", **kw)
            single_s.append(time.perf_counter() - t0)
        stack_busy = busy_ms(
            lambda: port.compress_audio_packed(stack, 44100, 2, device="cuda", **kw))[1]
        single_busy = busy_ms(
            lambda: [port.compress_audio_arrays(sg, 44100, 2, device="cuda", **kw)
                     for sg in stack])[1]
        t0 = time.perf_counter()
        for sg in stack:
            build_domains_host(sg, cfg.tile_size, cfg.range_size, cfg.domain_step)
        host_bank_s = time.perf_counter() - t0
        seconds = sum(len(sg) for sg in stack) / 44100
        out[phase] = launches
        emit({"phase": phase, "card": smi, "files": len(sigs), "plan": list(plan),
              "stacks": stacks, "launches": launches, "files_equal_to_single": len(sigs),
              "live_ranges": live, "stack_files": len(stack), "stack_seconds_audio": seconds,
              "stack_wall_s_median3": statistics.median(stack_s),
              "singles_wall_s_median3": statistics.median(single_s),
              "stack_x_realtime": seconds / statistics.median(stack_s),
              "singles_x_realtime": seconds / statistics.median(single_s),
              "stack_busy_ms": stack_busy, "singles_busy_ms": single_busy,
              "host_bank_build_s": host_bank_s, "peak_mem_mb": peak})
    return out


def staged_phase(port, kernels, smi):
    """The single-shot geometries that take the staged refine, on the card:
    held to the JAX CPU run's numbers (STAGED); K2 must not launch. The
    host's plain run of these files is not repeated here (140-170 s for
    the 60 s damped file alone): STAGED holds the results and
    staged_kernel_checks the kernels against their plain versions at these
    shapes. Returns the launch counts per case."""
    import numpy as np
    import torch

    from bench import make_signal
    from fwav_tpu_torch.models import encode as enc

    out = {}
    for name, case in STAGED.items():
        sig = make_signal(case["seconds"])
        kw = case["kw"]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        scan = "topc_scan" if kw.get("objective") == "damped" else "search_scan"
        cfg = port.EncoderConfig(**kw)
        _, _, _, lb, db = enc._prep_signal(sig, cfg)
        stride = enc._plan_search(cfg, lb // cfg.range_size, db)[1]
        table = kernels.staged_uses_table(cfg.range_size, stride, enc._coarse_topc(cfg), False)
        if launches[scan] != 1 or launches["refine_window"] or launches["window_stats"] or (
                launches["staged_refine"] != 1 or launches["staged_stats"] != table):
            raise AssertionError(f"staged {name}: launches {launches}, expected {scan} and K4 "
                                 f"once each, and K4's table {int(table)} times")
        rec, bank, n_ranges, rs, *_, olen = res
        sentinels = int((rec["idx"] < 0).sum())
        if n_ranges != case["n_ranges"] or sentinels != case["sentinels"]:
            raise AssertionError(f"staged {name}: {sentinels} sentinels in {n_ranges} ranges")
        recon = port.decompress_audio(rec, bank, n_ranges, rs, original_len=olen,
                                      device="cuda", **case["decode"])
        if not np.isfinite(recon).all() or recon.shape != sig.shape:
            raise AssertionError(f"staged {name}: the decode is not finite or has the wrong "
                                 "length")
        snr = port.compute_snr(sig, recon)
        if abs(snr - case["snr_db"]) > SNR_TOL_DB:
            raise AssertionError(f"staged {name}: SNR {snr} dB, expected {case['snr_db']} "
                                 f"+/- {SNR_TOL_DB}")
        t0 = time.perf_counter()
        port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        enc_s = time.perf_counter() - t0
        out[f"staged_{name}"] = launches
        emit({"phase": "staged", "case": name, "card": smi, "seconds_audio": case["seconds"],
              "config": kw, "n_ranges": n_ranges, "sentinels": sentinels, "snr_db": snr,
              "snr_db_jax_cpu": case["snr_db"], "launches": launches,
              "encode_s_first": first_s, "encode_s_second": enc_s,
              "x_realtime": case["seconds"] / enc_s, "peak_mem_mb": peak})
    return out


def wide_phase(port, kernels, smi, sig):
    """The 10 s file at tiles 8192 and 16384 (range sizes 32 and 64, which
    K1 and K3 scan with their wide kernels), held to the JAX CPU run's
    numbers (WIDE); then `compress --tile 8192` and `--tile 16384` through
    the CLI (the API's bytes) and back. Returns the launch counts per case."""
    import numpy as np
    import torch

    from fwav_tpu_torch.models import encode as enc

    out, report = {}, {"phase": "wide_tiles", "card": smi}
    api = {}
    for name, case in WIDE.items():
        kw = case["kw"]
        cfg = port.EncoderConfig(**kw)
        _, _, _, lb, db = enc._prep_signal(sig, cfg)
        plan = list(enc._plan_search(cfg, lb // cfg.range_size, db))
        if plan != case["plan"]:
            raise AssertionError(f"wide {name}: the plan is {plan}")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        scan = "topc_scan_wide" if kw.get("objective") == "damped" else "search_scan_wide"
        k4 = int(plan[2] == "staged")
        want = {**dict.fromkeys(launches, 0), scan: 1, "staged_refine": k4, "staged_stats": k4,
                "bank_means": 1, "collect_refit": 1}
        if launches != want:
            raise AssertionError(f"wide {name}: launches {launches}, expected {want}")
        rec, bank, n_ranges, rs, *_, olen = res
        sentinels = int((rec["idx"] < 0).sum())
        if n_ranges != case["n_ranges"] or sentinels != case["sentinels"]:
            raise AssertionError(f"wide {name}: {sentinels} sentinels in {n_ranges} ranges")
        recon = port.decompress_audio(rec, bank, n_ranges, rs, original_len=olen,
                                      device="cuda", **case["decode"])
        snr = port.compute_snr(sig, recon)
        if not np.isfinite(recon).all() or abs(snr - case["snr_db"]) > SNR_TOL_DB:
            raise AssertionError(f"wide {name}: SNR {snr} dB, expected {case['snr_db']}")
        t0 = time.perf_counter()
        again = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        enc_s = time.perf_counter() - t0
        if not same_result(res, again):
            raise AssertionError(f"wide {name}: a second encode differs from the first")
        if not kw.get("objective"):
            api[kw["tile_size"]] = port.prune_bank(rec, bank), res
        out[f"wide_{name}"] = launches
        report[name] = {"config": kw, "plan": plan, "n_ranges": n_ranges,
                        "sentinels": sentinels, "snr_db": snr,
                        "snr_db_jax_cpu": case["snr_db"], "launches": launches,
                        "encode_s_first": first_s, "encode_s_second": enc_s,
                        "x_realtime": 10.0 / enc_s,
                        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        wav = d / "bench10.wav"
        port.write_wav(wav, sig, 44100, 2)
        for tile, ((prec, pbank), res) in api.items():
            path, mine = d / f"t{tile}.fwav", d / f"api{tile}.fwav"
            launches, wall, _, _ = cli_call(kernels, ["compress", wav, path, "--tile", tile])
            need(f"cli --tile {tile}", launches,
                 {"search_scan_wide": 1, "staged_refine": int(tile == 8192),
                  "staged_stats": int(tile == 8192)})
            port.save_compressed(mine, prec, pbank, res[3], 44100, 2, *res[4:])
            if path.read_bytes() != mine.read_bytes():
                raise AssertionError(f"cli --tile {tile}: the file differs from the API's")
            cli_call(kernels, ["decompress", path, "--out", d / f"r{tile}.wav"])
            snr = json.loads(cli_call(kernels, ["snr", wav, d / f"r{tile}.wav"])[2])["snr_db"]
            name = "tile8192_balanced" if tile == 8192 else "tile16384_exact"
            if abs(snr - WIDE[name]["snr_db"]) > SNR_TOL_DB:
                raise AssertionError(f"cli --tile {tile}: SNR {snr} dB")
            out[f"wide_cli_tile{tile}"] = launches
            report[f"cli_tile{tile}"] = {"compress_wall_s": wall, "launches": launches,
                                         "snr_db": snr, "bytes": path.stat().st_size}
    emit(report)
    return out


#: Calls of each captured path timed eager and replayed, in turns.
GRAPH_TIMED_CALLS = 12
#: The graphs phase's staged-plan cases (K4) and the numbers their replays
#: are held to.
STAGED_GRAPHS = {"single_tile512": STAGED["tile512_balanced"],
                 "single_tile512_damped": STAGED["tile512_damped"],
                 "single_tile8192": WIDE["tile8192_balanced"]}


@contextlib.contextmanager
def eager_programs():
    """Every device program of fwav_tpu_torch runs eagerly inside the block,
    as before the capture (models/encode.py _captured patched to say no):
    the yardstick of the graphs phase. The package itself has no such
    switch."""
    from fwav_tpu_torch.models import encode as enc
    from fwav_tpu_torch.models import stream

    saved = enc._captured
    enc._captured = stream._captured = lambda *a: False
    try:
        yield
    finally:
        enc._captured = stream._captured = saved


#: Each kernel's launch key (ops/kernels.py LAUNCHES) by the name of its
#: CUDA function: a trace names a kernel that a replayed graph ran.
KERNEL_KEYS = (("search_scan_wide_kernel", "search_scan_wide"),
               ("search_scan_kernel", "search_scan"),
               ("topc_scan_wide_kernel", "topc_scan_wide"),
               ("topc_scan_kernel", "topc_scan"),
               ("refine_window_kernel", "refine_window"),
               ("window_stats_kernel", "window_stats"),
               ("staged_refine_kernel", "staged_refine"),
               ("staged_stats_kernel", "staged_stats"),
               ("bank_means_kernel", "bank_means"),
               ("collect_refit_kernel", "collect_refit"))


def traced_kernels(fn):
    """fn() under torch.profiler (padded): {launch key: the kernels of
    that name the card ran for fn} and the count of fn's device records
    the profiler lost."""
    from torch.profiler import ProfilerActivity, profile

    with counted_replays() as graphs:
        with padded(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) as (
                prof, ns):
            fn()
    recs, _, lost = device_work(prof, ns, graphs)
    names = [e.name() for e in recs]
    return {key: sum(kname in n for n in names) for kname, key in KERNEL_KEYS}, lost


def graphs_phase(port, kernels, smi, sig, stream_sig):
    """The captured programs (fwav_tpu_torch/models/program.py) against the
    eager runs of the same calls: every captured path's replayed records
    byte-equal to its eager records, with the eager launch counts, and a
    profiled replay naming on the card each kernel those counts name; the
    main paths' sentinels and SNR; two lengths of one bucket through one
    capture (a key's first call eager, its second captured); two threads
    replaying one key in turns, each with its own records; the enqueue
    (device less d2h, or the stream's dispatch) eager and replayed; each
    program's capture time, nodes and pool bytes. Returns the launch
    counts of the replayed paths."""
    import threading

    import numpy as np

    from fwav_tpu_torch.models.program import PROGRAMS
    from fwav_tpu_torch.utils import collect_phases

    out, report = {}, {"phase": "graphs", "card": smi}
    ten = packed_signals(10.0, PACK_FILES)
    clips = packed_signals(0.5, PACK_FILES, seed0=200)

    def single(s, **kw):
        return lambda: port.compress_audio_arrays(s, 44100, 2, device="cuda", **kw)

    def packed(sigs, **kw):
        return lambda: port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)

    def streamed(**kw):
        return lambda: port.compress_audio_streaming(stream_sig, 44100, 2, device="cuda",
                                                     **kw)

    cases = [("single_default", single(sig), "single"),
             ("single_damped", single(sig, objective="damped"), "single"),
             ("single_exact_clip", single(clips[0]), "single"),
             ("single_tile512", single(sig, tile_size=512), "single"),
             ("single_tile512_damped", single(sig, tile_size=512, objective="damped"),
              "single"),
             ("single_tile8192", single(sig, tile_size=8192), "single"),
             ("packed_10s", packed(ten), "packed"),
             ("packed_clips", packed(clips), "packed"),
             ("packed_tile512_damped", packed(ten, tile_size=512, objective="damped"),
              "packed"),
             ("stream_balanced", streamed(), "stream"),
             ("stream_damped", streamed(objective="damped"), "stream")]
    for name, fn, kind in cases:
        with eager_programs():
            kernels.reset_launch_counts()
            eager = fn()
            eager_launches = dict(kernels.LAUNCHES)
        for _ in range(2):
            fn()  # a new key: runs eagerly, then captures
        before = PROGRAMS.stats()
        kernels.reset_launch_counts()
        replayed = fn()
        launches = dict(kernels.LAUNCHES)
        after = PROGRAMS.stats()
        if after["captures"] != before["captures"] or after["replays"] <= before["replays"]:
            raise AssertionError(f"graphs {name}: no replay ({before} -> {after})")
        results = zip(eager, replayed) if kind == "packed" else [(eager, replayed)]
        if not all(same_result(a, b) for a, b in results):
            raise AssertionError(f"graphs {name}: the replayed records differ from the eager")
        if launches != eager_launches:
            raise AssertionError(f"graphs {name}: launches {launches}, eager {eager_launches}")
        for _ in range(2):  # again if the profiler lost a record
            traced, lost = traced_kernels(fn)
            if not lost:
                break
        want = {k: launches[k] for _, k in KERNEL_KEYS}
        if lost or traced != want:
            raise AssertionError(f"graphs {name}: the card ran kernels {traced} ({lost} records "
                                 f"lost), the counts say {want}")
        out[f"graphs_{name}"] = launches
        report[name] = {"launches": launches, "traced_kernels": traced,
                        "replays": after["replays"] - before["replays"]}
        if name == "single_default":
            rec = replayed[0]
            recon = port.decompress_audio(rec, replayed[1], replayed[2], replayed[3],
                                          original_len=replayed[7], device="cuda")
            snr = port.compute_snr(sig, recon)
            if int((rec["idx"] < 0).sum()) != SLICE_SENTINELS or abs(
                    snr - SLICE_SNR_DB) > SNR_TOL_DB:
                raise AssertionError(f"graphs {name}: SNR {snr} dB")
            report[name]["snr_db"] = snr
        if name == "single_damped":
            rec = replayed[0]
            recon = port.decompress_audio(rec, replayed[1], replayed[2], replayed[3],
                                          original_len=replayed[7], s_damping=0.25,
                                          device="cuda")
            snr = port.compute_snr(sig, recon)
            if int((rec["idx"] < 0).sum()) != DAMPED_SENTINELS or abs(
                    snr - DAMPED_RECORDS_SNR_DB) > SNR_TOL_DB:
                raise AssertionError(f"graphs {name}: SNR {snr} dB")
            report[name]["records_snr_db"] = snr
        if kind == "stream" and int((replayed[0]["idx"] < 0).sum()) != STREAM_SENTINELS:
            raise AssertionError(f"graphs {name}: the sentinels differ")
        if name in STAGED_GRAPHS:  # the staged plan's replays: STAGED's and WIDE's numbers
            case = STAGED_GRAPHS[name]
            rec = replayed[0]
            snr = port.compute_snr(sig, port.decompress_audio(
                rec, replayed[1], replayed[2], replayed[3], original_len=replayed[7],
                device="cuda", **case["decode"]))
            if int((rec["idx"] < 0).sum()) != case["sentinels"] or abs(
                    snr - case["snr_db"]) > SNR_TOL_DB:
                raise AssertionError(f"graphs {name}: SNR {snr} dB")
            report[name]["snr_db"] = snr

    # the enqueue, eager and replayed in turns (host clock)
    def enqueue_ms(fn):
        with collect_phases() as ph:
            fn()
        return (ph["device"] - ph["d2h"]) * 1e3

    def dispatch_ms(kw):
        stats = {}
        port.compress_audio_streaming(stream_sig, 44100, 2, device="cuda", stats=stats, **kw)
        return sum(sh["h2d_ms"] + sh["enqueue_ms"] for sh in stats["shards"])

    timing = {}
    for name, fn, reps in (("single_default", single(sig), GRAPH_TIMED_CALLS),
                           ("single_damped", single(sig, objective="damped"),
                            GRAPH_TIMED_CALLS),
                           ("single_tile512_damped",
                            single(sig, tile_size=512, objective="damped"), GRAPH_TIMED_CALLS),
                           ("packed_10s", packed(ten), 3)):
        e, r = [], []
        for _ in range(reps):
            with eager_programs():
                e.append(enqueue_ms(fn))
            r.append(enqueue_ms(fn))
        timing[name] = {"eager_enqueue_ms_median": statistics.median(e),
                        "replay_enqueue_ms_median": statistics.median(r), "calls": reps}
    for name, kw in (("stream_balanced", {}), ("stream_damped", {"objective": "damped"})):
        e, r = [], []
        for _ in range(3):
            with eager_programs():
                e.append(dispatch_ms(kw))
            r.append(dispatch_ms(kw))
        timing[name] = {"eager_dispatch_ms_median": statistics.median(e),
                        "replay_dispatch_ms_median": statistics.median(r), "shards": 5}
    report["enqueue"] = timing

    # two lengths of one bucket: one capture, each file its own records
    other = sig[:-3000]
    with eager_programs():
        want = [port.compress_audio_arrays(s, 44100, 2, device="cuda") for s in (sig, other)]
    PROGRAMS.clear()
    got, walls = [], []
    for s in (sig, other, sig, other):
        t0 = time.perf_counter()
        got.append(port.compress_audio_arrays(s, 44100, 2, device="cuda"))
        walls.append(time.perf_counter() - t0)
    st = PROGRAMS.stats(memory=True)
    if (st["first_calls"], st["captures"], st["replays"]) != (1, 1, 2):
        raise AssertionError(f"graphs: two lengths of one bucket took {st}")
    if not all(same_result(a, b) for a, b in zip(got, want + want)):
        raise AssertionError("graphs: a length of the bucket lost its own records")
    prog = st["programs"][0]
    report["one_bucket"] = {"lengths": [len(sig), len(other)], "first_calls": 1,
                            "captures": 1, "first_call_wall_s": walls[0],
                            "capture_call_wall_s": walls[1], "replay_wall_s": walls[2:],
                            **prog, "key": repr(prog["key"])}

    # two threads replaying one key in turns, each with its own records
    results = {0: [], 1: []}

    def worker(k, s):
        for _ in range(6):
            results[k].append(port.compress_audio_arrays(s, 44100, 2, device="cuda"))

    threads = [threading.Thread(target=worker, args=(k, s)) for k, s in enumerate((sig, other))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in (0, 1):
        if len(results[k]) != 6 or not all(same_result(r, want[k]) for r in results[k]):
            raise AssertionError(f"graphs: thread {k} got another thread's records")
    report["threads"] = {"threads": 2, "calls_each": 6, "all_own_records": True}

    # every program held now: capture time, nodes, pool
    for name, fn, _ in cases:
        for _ in range(2):
            fn()
    st = PROGRAMS.stats(memory=True)
    report["programs"] = [{**p, "key": repr(p["key"])} for p in st["programs"]]
    report["cache"] = {k: st[k] for k in ("capacity", "entries", "first_calls", "captures",
                                          "replays", "evictions")}
    emit(report)
    return out


def stereo_pair():
    """Ten seconds of stereo: a packed_signals file left, 0.7 of it plus
    0.3 of another right."""
    import numpy as np

    left, other = packed_signals(10.0, 2, seed0=300)
    return np.stack([left, np.round(0.7 * left + 0.3 * other)], axis=1).astype(np.float32)


def multichannel_phase(port, kernels, smi):
    """A stereo pair through mid/side, one damped packed call for both
    channels, the v3 container with the decode hint, the hinted decode on
    the card and the inverse transform, against the same pipeline on the
    host; then a segment against the slice of the full decode. Returns the
    encode's launch counts and the card's v3 bytes."""
    import numpy as np

    from fwav_tpu_torch.io import multich
    from fwav_tpu_torch.ops import near_tie

    stereo = stereo_pair()
    ms = multich.ms_forward(stereo)
    chans = [np.ascontiguousarray(ms[:, c]) for c in range(2)]

    def pipeline(device, tmp):
        kernels.reset_launch_counts()
        enc_res = port.compress_audio_packed(chans, 44100, 2, objective="damped",
                                             device=device)
        launches = dict(kernels.LAUNCHES)
        tuples = []
        for rec, bank, _, rs, tile, step, thr, olen in enc_res:
            prec, pbank = port.prune_bank(rec, bank)
            tuples.append((prec, pbank, rs, 44100, 2, tile, step, thr, olen))
        path = Path(tmp) / f"stereo_{device}.fwav"
        port.save_compressed_multi(path, tuples, transform=multich.TRANSFORM_MS,
                                   decode_damping=port.DAMPED_DECODE_DAMPING)
        data = path.read_bytes()
        hint = multich.multi_decode_hint(data)
        if hint != port.DAMPED_DECODE_DAMPING:
            raise AssertionError(f"multichannel: the decode hint read back is {hint}")
        loaded, transform = port.load_compressed_multi(path)
        if transform != multich.TRANSFORM_MS or len(loaded) != 2:
            raise AssertionError("multichannel: the container did not keep its channels")
        stats = [{}, {}]
        dec = [port.decompress_audio(c[0], c[1], c[2], c[3], original_len=c[9],
                                     s_damping=hint, stats=st, device=device)
               for c, st in zip(loaded, stats)]
        recon = multich.ms_inverse(np.stack(dec, axis=1))
        snr = [port.compute_snr(stereo[:, c], recon[:, c]) for c in range(2)]
        return enc_res, launches, loaded, hint, recon, snr, stats, len(data), data

    with tempfile.TemporaryDirectory() as tmp:
        gpu = pipeline("cuda", tmp)
        cpu = pipeline("cpu", tmp)
    enc_res, launches, loaded, hint, recon, snr, stats, size, _ = gpu
    # the bank is built on the card only where both channels are whole numbers
    whole = all(np.array_equal(c, np.round(c)) for c in chans)
    if launches != {**dict.fromkeys(launches, 0), "topc_scan": 1, "refine_window": 1,
                    "window_stats": 1, "bank_means": int(whole),
                    "collect_refit": int(whole)}:
        raise AssertionError(f"multichannel: both channels are one stack, launches {launches}")
    if not np.isfinite(recon).all() or recon.shape != stereo.shape:
        raise AssertionError("multichannel: the decode is not finite or has the wrong shape")
    diffs = []
    for c in range(2):
        a, b = enc_res[c][0]["idx"], cpu[0][c][0]["idx"]
        if not np.array_equal(a < 0, b < 0):
            raise AssertionError(f"multichannel: channel {c}'s sentinel sets differ from the host")
        diffs.append(int((a != b).sum()))
        if diffs[-1] > near_tie.allowed_diffs(len(a)):
            raise AssertionError(f"multichannel: channel {c}: {diffs[-1]} idx differ from the host")
        if abs(snr[c] - cpu[5][c]) > SNR_TOL_DB:
            raise AssertionError(f"multichannel: channel {c} SNR {snr[c]} dB on the card, "
                                 f"{cpu[5][c]} dB on the host")

    # a segment of the mid channel: bit-equal to the slice at s_damping=0;
    # on the loop bit-equal when both run the same count of iterations
    # (convergence_eps=0), and within SEGMENT_RTOL of the peak at the hint's
    # default stop test (the delta is over the chunk that is decoded)
    rec, bank, n, rs, *_, olen = loaded[0]
    a, b = 3 * 44100 + 17, 5 * 44100 + 3
    full0 = port.decompress_audio(rec, bank, n, rs, original_len=olen, device="cuda")
    seg0 = port.decompress_segment(rec, bank, n, rs, a, b, original_len=olen, device="cuda")
    if not np.array_equal(seg0, full0[a:b]):
        raise AssertionError("segment: differs from the slice of the full decode at s_damping=0")
    loop = dict(original_len=olen, s_damping=hint, device="cuda")
    fixed = dict(loop, convergence_eps=0.0)
    if not np.array_equal(
            port.decompress_segment(rec, bank, n, rs, a, b, **fixed),
            port.decompress_audio(rec, bank, n, rs, **fixed)[a:b]):
        raise AssertionError("segment: differs from the slice on the loop at 8 iterations")
    seg_stats = {}
    seg = port.decompress_segment(rec, bank, n, rs, a, b, stats=seg_stats, **loop)
    full = port.decompress_audio(rec, bank, n, rs, **loop)
    seg_err = float(np.max(np.abs(seg - full[a:b])))
    peak_abs = float(np.max(np.abs(full)))
    if seg_err > SEGMENT_RTOL * peak_abs:
        raise AssertionError(f"segment: max err {seg_err} on the loop, peak {peak_abs}")
    emit({"phase": "multichannel", "card": smi, "seconds_audio": len(stereo) / 44100,
          "transform": "mid/side", "launches": launches, "decode_hint": hint,
          "snr_db_left_right": snr, "snr_db_left_right_host": cpu[5],
          "idx_diff_vs_host_mid_side": diffs, "decode_stats": stats, "v3_bytes": size,
          "v3_bytes_host": cpu[7],
          "segment": {"samples": [a, b], "equal_at_s_damping_0": True,
                      "equal_on_the_loop_at_8_iterations": True,
                      "max_abs_err_on_the_loop": seg_err, "peak_abs": peak_abs,
                      "iterations_segment": seg_stats["iterations"],
                      "iterations_full": stats[0]["iterations"]}})
    return launches, gpu[8]



def cli_call(kernels, argv):
    """fwav_tpu_torch.cli.main(argv) in this process with the launch
    counts set to 0 just before: (its launches, host-clock seconds, what it
    printed, the card's peak memory in MB)."""
    import io

    import torch

    from fwav_tpu_torch import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return (dict(kernels.LAUNCHES), seconds, buf.getvalue(),
            torch.cuda.max_memory_allocated() / 2**20)


def need(name, launches, want):
    """Each kernel of `want` launched at least that often."""
    short = {k: v for k, v in want.items() if launches[k] < v}
    if short:
        raise AssertionError(f"{name}: launches {launches}, expected at least {want}")


def cli_phase(port, kernels, smi, sig, stream_sig, api_files):
    """The CLI (fwav_tpu_torch.cli.main in this process, so that the launch
    counts can be read around each call) on the main paths' files, held to
    the in-process API's bytes and the JAX package's numbers; the module
    entry point in subprocesses; and the topk mode held to TOPK. Returns the
    launch counts of every call that runs a path."""
    import numpy as np

    from fwav_tpu_torch.io import multich

    out, calls = {}, {}

    def call(name, argv, seconds_audio=None):
        launches, wall, printed, peak = cli_call(kernels, argv)
        calls[name] = {"wall_s": wall, "launches": launches, "peak_mem_mb": peak}
        if seconds_audio:
            calls[name]["x_realtime"] = seconds_audio / wall
        return launches, printed

    def snr_of(wav, recon):
        return json.loads(call(f"snr {Path(recon).name}", ["snr", wav, recon])[1])["snr_db"]

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        wav10 = d / "bench10.wav"
        port.write_wav(wav10, sig, 44100, 2)
        # 1-2. the default compress, its file, info --verify, a bare decompress
        out["cli_default"] = call("compress", ["compress", wav10, d / "b.fwav"], 10.0)[0]
        need("cli default", out["cli_default"],
             {"search_scan": 1, "refine_window": 1, "window_stats": 1})
        if (d / "b.fwav").read_bytes() != api_files["default"]:
            raise AssertionError("cli default: the file differs from the API-written one")
        rec = port.load_compressed_arrays(d / "b.fwav")[0]
        sentinels = int((rec["idx"] < 0).sum())
        if len(rec) != SLICE_RANGES or sentinels != SLICE_SENTINELS:
            raise AssertionError(f"cli default: {sentinels} sentinels in {len(rec)} ranges")
        info = json.loads(call("info --verify", ["info", d / "b.fwav", "--verify"])[1])
        if info["checksum"] != "verified" or info["silent_sentinel_ranges"] != SLICE_SENTINELS:
            raise AssertionError(f"cli info: {info}")
        call("decompress", ["decompress", d / "b.fwav", "--out", d / "b_recon.wav"], 10.0)
        snr = snr_of(wav10, d / "b_recon.wav")
        if abs(snr - SLICE_SNR_DB) > SNR_TOL_DB:
            raise AssertionError(f"cli default: SNR {snr} dB, expected {SLICE_SNR_DB}")
        # 3. --compact: the damped profile, v2 with the hint, the hinted decode
        launches = call("compress --compact", ["compress", wav10, d / "c.fwav", "--compact"],
                        10.0)[0]
        need("cli compact", launches, {"topc_scan": 1, "refine_window": 1, "window_stats": 1})
        out["cli_compact"] = launches
        if (d / "c.fwav").read_bytes() != api_files["compact"]:
            raise AssertionError("cli compact: the file differs from the damped phase's v2")
        if port.parse_decode_hint((d / "c.fwav").read_bytes()[:128]) != 0.25:
            raise AssertionError("cli compact: the stored hint is not 0.25")
        call("decompress (hint)", ["decompress", d / "c.fwav", "--out", d / "c_recon.wav"],
             10.0)
        snr_c = snr_of(wav10, d / "c_recon.wav")
        if abs(snr_c - DAMPED_SNR_DB) > SNR_TOL_DB:
            raise AssertionError(f"cli compact: SNR {snr_c} dB, expected {DAMPED_SNR_DB}")
        from fwav_tpu_torch.models.codec import process_file_decompress

        dec = process_file_decompress(str(d / "c.fwav"), str(d / "c2.wav"))
        if dec.get("decode_iterations") != DAMPED_ITERATIONS or dec.get("s_damping") != 0.25:
            raise AssertionError(f"cli compact: the hinted decode reported {dec}")
        # 8. a segment equals the slice of the full decode
        call("decompress --start 2 --duration 3",
             ["decompress", d / "b.fwav", "--start", 2, "--duration", 3], 3.0)
        seg = port.read_wav_mono(d / "b_recon_seg_2s+3s.wav")[0]
        full = port.read_wav_mono(d / "b_recon.wav")[0]
        if not np.array_equal(seg, full[2 * 44100 : 5 * 44100]):
            raise AssertionError("cli segment: differs from the slice of the full decode")

        # the module entry point in subprocesses
        proc = {}
        for name, argv in (("warmup", ["warmup", "--seconds", "10"]),
                           ("compress", ["compress", wav10, d / "p.fwav"])):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "fwav_tpu_torch", *map(str, argv)],
                           check=True, timeout=300, capture_output=True, text=True)
            proc[name] = time.perf_counter() - t0
        if (d / "p.fwav").read_bytes() != api_files["default"]:
            raise AssertionError("cli process: the subprocess's file differs")
        emit({"phase": "cli_process", "card": smi, "seconds": proc,
              "file_equal_to_in_process": True})

        # topk: the compatibility mode, no search kernel (the 16-bit file's bank is
        # bank_means', its refit collect_refit's), held to the JAX CLI's run
        launches = call("compress --search topk", ["compress", wav10, d / "t.fwav", "--search",
                                                   "topk"], 10.0)[0]
        if launches != {**dict.fromkeys(launches, 0), "bank_means": 1, "collect_refit": 1}:
            raise AssertionError(f"topk launched kernels: {launches}")
        out["topk"] = launches
        rec = port.load_compressed_arrays(d / "t.fwav")[0]
        sentinels = int((rec["idx"] < 0).sum())
        call("decompress (topk)", ["decompress", d / "t.fwav", "--out", d / "t_recon.wav"])
        snr_t = snr_of(wav10, d / "t_recon.wav")
        if len(rec) != TOPK["n_ranges"] or sentinels != TOPK["sentinels"] or abs(
                snr_t - TOPK["snr_db"]) > SNR_TOL_DB:
            raise AssertionError(f"topk: {sentinels} sentinels in {len(rec)}, {snr_t} dB; "
                                 f"the JAX CLI's {TOPK}")
        emit({"phase": "topk", "card": smi, "sentinels": sentinels, "snr_db": snr_t,
              "snr_db_jax_cpu": TOPK["snr_db"], "launches": launches,
              "encode_wall_s": calls["compress --search topk"]["wall_s"],
              "x_realtime": calls["compress --search topk"]["x_realtime"]})

        # 4. the 100 s file: the streaming branch and the prune from the signal
        wav100 = d / "bench100.wav"
        port.write_wav(wav100, stream_sig, 44100, 2)
        seconds = len(stream_sig) / 44100
        for name, flags, want, floor in (
                ("cli_stream_balanced", [], STREAM_BALANCED_SNR_DB,
                 {"search_scan": 5, "refine_window": 5, "window_stats": 5}),
                ("cli_stream_damped", ["--compact"], STREAM_DAMPED_SNR_DB,
                 {"topc_scan": 6, "refine_window": 5, "window_stats": 5, "staged_refine": 1})):
            fwav = d / f"{name}.fwav"
            launches = call(f"compress 100 s {flags}", ["compress", wav100, fwav, *flags],
                            seconds)[0]
            need(name, launches, floor)
            out[name] = launches
            call(f"decompress 100 s {flags}", ["decompress", fwav, "--out", d / f"{name}.wav"],
                 seconds)
            snr_s = snr_of(wav100, d / f"{name}.wav")
            if abs(snr_s - want) > SNR_TOL_DB:
                raise AssertionError(f"{name}: SNR {snr_s} dB, expected {want}")
            calls[f"compress 100 s {flags}"]["snr_db"] = snr_s
            if not flags:  # the v1 file: its read with and without the SHA-256 check
                read_s = {}
                for verify in (True, False, True, False):
                    t0 = time.perf_counter()
                    port.load_compressed_arrays(fwav, verify_checksum=verify)
                    read_s.setdefault("checksum" if verify else "no_checksum", []).append(
                        time.perf_counter() - t0)
                calls[f"decompress 100 s {flags}"]["v1_read_s"] = read_s

        # 5-6. --batch --packed and the thread pool on the packed phase's files
        batch = d / "batch"
        batch.mkdir()
        sigs = packed_signals(10.0, PACK_FILES) + packed_signals(7.0, 1, seed0=99)
        for i, sg in enumerate(sigs):
            port.write_wav(batch / f"f{i:02d}.wav", sg, 44100, 2)
        launches = call("compress --batch --packed", ["compress", batch, "--batch", "--packed",
                                                      "--out", d / "packed"],
                        10.0 * PACK_FILES + 7.0)[0]
        want = {**dict.fromkeys(launches, 0), "search_scan": 2, "refine_window": 2,
                "window_stats": 2, "bank_means": 2, "collect_refit": 2}
        if launches != want:
            raise AssertionError(f"cli packed: launches {launches}, one of each kernel per "
                                 f"stack: {want}")
        out["cli_packed"] = launches
        metrics = json.loads((d / "packed" / "compression_metrics.json").read_text())
        if len(metrics) != len(sigs) or not all(m.get("packed") is True for m in metrics):
            raise AssertionError(f"cli packed: metrics {metrics}")
        ref = port.compress_audio_packed(sigs, 44100, 2, device="cuda")
        for i, res in enumerate(ref):
            rec, bank, _, rs, tile, step, thr, olen = res
            prec, pbank = port.prune_bank(rec, bank)
            path = d / f"ref{i:02d}.fwav"
            port.save_compressed(path, prec, pbank, rs, 44100, 2, tile, step, thr, olen)
            if path.read_bytes() != (d / "packed" / f"f{i:02d}.wav.fwav").read_bytes():
                raise AssertionError(f"cli packed: file {i} differs from compress_audio_packed")
        for w in (1, 4):
            out[f"cli_workers{w}"] = call(f"compress --batch --workers {w}",
                                          ["compress", batch, "--batch", "--workers", w,
                                           "--out", d / f"w{w}"], 10.0 * PACK_FILES + 7.0)[0]
        for i in range(len(sigs)):
            name = f"f{i:02d}.wav.fwav"
            if (d / "w1" / name).read_bytes() != (d / "w4" / name).read_bytes():
                raise AssertionError(f"cli workers: {name} differs between 1 and 4 workers")
        if (d / "w1" / "f00.wav.fwav").read_bytes() != (d / "packed" / "f00.wav.fwav").read_bytes():
            raise AssertionError("cli workers: a file differs from the packed batch's")

        # 7. --channels ms on the multichannel phase's stereo pair
        st = d / "stereo.wav"
        port.write_wav(st, stereo_pair(), 44100, 2)
        out["cli_ms"] = call("compress --channels ms", ["compress", st, d / "st.fwav",
                                                       "--channels", "ms"], 10.0)[0]
        need("cli ms", out["cli_ms"], {"topc_scan": 1, "refine_window": 1, "window_stats": 1})
        data = (d / "st.fwav").read_bytes()
        if data[4] != 3 or data != api_files["ms"]:
            raise AssertionError("cli ms: the v3 file differs from the multichannel phase's")
        if multich.multi_decode_hint(data) != 0.25:
            raise AssertionError("cli ms: the stored hint is not 0.25")
    emit({"phase": "cli", "card": smi, "sentinels": SLICE_SENTINELS, "snr_db": snr,
          "snr_db_compact": snr_c, "compact_iterations": dec["decode_iterations"],
          "files_equal_to_api": ["default", "compact", "ms", "packed", "subprocess"],
          "calls": calls})
    return out


#: The (dp, tp) meshes of the mesh phase's 10 s encodes.
MESH_SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1)]
#: The SNR bar of the damped decode over dp 4 against the one-device
#: constant: each slab stops on its own delta, as in the JAX package, whose
#: tests hold its sharded decode within 0.05 dB (tests/test_sharding.py).
MESH_DECODE_SNR_TOL_DB = 0.05

_LOOPBACK_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from bench import make_signal
import fwav_tpu_torch as port
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.parallel import compress_audio_sharded, init_distributed
proc, port_no = int(sys.argv[1]), sys.argv[2]
mesh = init_distributed("localhost:" + port_no, 2, proc, device="cuda", local_devices=["cuda:0"])
assert mesh.shape == {"dp": 2, "tp": 1} and mesh.local_rows() == [proc], mesh
sig = make_signal(10.0)
out = {"process": proc}
for name, kw in (("default", {}), ("damped", {"objective": "damped"})):
    one = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = compress_audio_sharded(sig, 44100, 2, mesh=mesh, **kw)
    out[name] = {"wall_s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                 "equal": bool(got[0].tobytes() == one[0].tobytes()
                               and np.array_equal(got[1], one[1]))}
print("LOOPBACK " + json.dumps(out), flush=True)
"""


def mesh_of(dp, tp):
    """A (dp, tp) mesh of distinct cards where torch.cuda.device_count()
    has dp * tp of them, else of cuda:0 repeated: (mesh, which)."""
    import numpy as np
    import torch

    from fwav_tpu_torch.parallel import Mesh

    n = dp * tp
    if torch.cuda.device_count() >= n:
        return Mesh(np.array([f"cuda:{i}" for i in range(n)], dtype=object).reshape(dp, tp)), \
            "distinct cards"
    return Mesh([["cuda:0"] * tp] * dp), "cuda:0 repeated"


def loopback(kernels):
    """Two processes on the card through init_distributed (gloo on the
    host, both on cuda:0): each holds the sharded 10 s encodes, default and
    damped, to its own single-device records. Returns each child's report."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port_no = str(sk.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", _LOOPBACK_CHILD, str(i), port_no],
                              cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in (0, 1)]
    reports = []
    try:
        for p in procs:
            out = p.communicate(timeout=240)[0]
            line = [ln for ln in out.splitlines() if ln.startswith("LOOPBACK ")]
            if p.returncode != 0 or not line:
                raise AssertionError(f"loopback process failed:\n{out[-3000:]}")
            reports.append(json.loads(line[-1][len("LOOPBACK "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in reports:
        for name, scan in (("default", "search_scan"), ("damped", "topc_scan")):
            rep = r[name]
            if not rep["equal"]:
                raise AssertionError(f"loopback p{r['process']} {name}: records differ")
            need(f"loopback p{r['process']} {name}", rep["launches"],
                 {scan: 1, "refine_window": 1, "window_stats": 1})
    return reports


def mesh_phase(port, kernels, smi, sig, stream_sig, api_files):
    """Multi-device meshes on the card (fwav_tpu_torch/parallel): cells on
    distinct cards where there are enough, else cuda:0 repeated, whose
    cells run one after another (no speed-up is expected or claimed).
    Every output is held byte for byte to the single-device run in this
    call, and the sentinels and SNR to the constants above. Returns the
    launch counts of the mesh runs."""
    import numpy as np
    import torch

    from fwav_tpu_torch.models import codec
    from fwav_tpu_torch.models.stream import _prune_streamed
    from fwav_tpu_torch.parallel import compress_audio_sharded
    from fwav_tpu_torch.utils.buckets import bucket, pad_to

    total = dict.fromkeys(kernels.LAUNCHES, 0)
    cases = []

    def run(name, fn, want, single_fn=None):
        """fn() with the counts at 0 just before; its launches must equal
        `want` (the others 0); then fn and single_fn timed once more."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        full = {k: want.get(k, 0) for k in launches}
        if launches != full:
            raise AssertionError(f"mesh {name}: launches {launches}, expected {full}")
        for k, v in launches.items():
            total[k] += v
        case = {"case": name, "launches": launches, "first_wall_s": first}
        for key, f in (("mesh_wall_s", fn), ("single_wall_s", single_fn)):
            if f is not None:
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                case[key] = time.perf_counter() - t0
        cases.append(case)
        return res, case

    # 10 s, default and damped, through compress_audio_sharded
    singles = {}
    for obj, scan, sentinels in (("balanced", "search_scan", SLICE_SENTINELS),
                                 ("damped", "topc_scan", DAMPED_SENTINELS)):
        single = lambda obj=obj: port.compress_audio_arrays(sig, 44100, 2, objective=obj,
                                                             device="cuda")
        singles[obj] = single()
        for dp, tp in MESH_SHAPES:
            mesh, which = mesh_of(dp, tp)
            cells = dp * tp
            res, case = run(f"10 s {obj} ({dp}, {tp})",
                            lambda: compress_audio_sharded(sig, 44100, 2, mesh=mesh,
                                                           objective=obj),
                            {scan: cells, "refine_window": cells, "window_stats": cells,
                             "bank_means": 1},
                            single)
            if not same_result(res, singles[obj]):
                raise AssertionError(f"mesh 10 s {obj} ({dp}, {tp}): the records differ")
            if int((res[0]["idx"] < 0).sum()) != sentinels:
                raise AssertionError(f"mesh 10 s {obj}: {(res[0]['idx'] < 0).sum()} sentinels")
            case.update(cells=cells, devices=which, equal_to_single=True)
    rec, bank, n_ranges, rs, *_ = singles["balanced"]
    snr = port.compute_snr(sig, port.decompress_audio(rec, bank, n_ranges, rs,
                                                      original_len=len(sig), device="cuda"))
    rec, bank, n_ranges, rs, *_ = singles["damped"]
    snr_d = port.compute_snr(sig, port.decompress_audio(rec, bank, n_ranges, rs,
                                                        original_len=len(sig),
                                                        s_damping=0.25, device="cuda"))
    if abs(snr - SLICE_SNR_DB) > SNR_TOL_DB or abs(snr_d - DAMPED_RECORDS_SNR_DB) > SNR_TOL_DB:
        raise AssertionError(f"mesh 10 s: SNR {snr} / {snr_d} dB")

    # the exact branch on a short file, the bank split over tp 2 and 4
    clip = packed_signals(0.5, 1, seed0=200)[0]
    one = port.compress_audio_arrays(clip, 44100, 2, search="exact", device="cuda")
    for tp in (2, 4):
        mesh, which = mesh_of(1, tp)
        res, case = run(f"0.5 s exact (1, {tp})",
                        lambda: compress_audio_sharded(clip, 44100, 2, mesh=mesh,
                                                       search="exact"),
                        {"search_scan": tp, "bank_means": 1},
                        lambda: port.compress_audio_arrays(clip, 44100, 2, search="exact",
                                                           device="cuda"))
        if not same_result(res, one):
            raise AssertionError(f"mesh exact tp {tp}: the records differ")
        case.update(cells=tp, devices=which, equal_to_single=True)

    # 100 s through the stream at (2, 2): 5 shards x 4 cells, the pass once
    mesh, which = mesh_of(2, 2)
    with tempfile.TemporaryDirectory() as tmp:
        for obj, want in (("balanced", {"search_scan": 20, "refine_window": 20,
                                        "window_stats": 20}),
                          ("damped", {"topc_scan": 21, "refine_window": 20,
                                      "window_stats": 20, "staged_refine": 1})):
            single = lambda obj=obj: port.compress_audio_streaming(
                stream_sig, 44100, 2, objective=obj, device="cuda")
            one = single()
            res, case = run(f"100 s stream {obj} (2, 2)",
                            lambda: port.compress_audio_streaming(stream_sig, 44100, 2,
                                                                  objective=obj, mesh=mesh),
                            want, single)
            if res[0].tobytes() != one[0].tobytes() or tuple(res[2:]) != tuple(one[2:]):
                raise AssertionError(f"mesh stream {obj}: the records differ")
            if res[2] != STREAM_RANGES or int((res[0]["idx"] < 0).sum()) != STREAM_SENTINELS:
                raise AssertionError(f"mesh stream {obj}: the sentinels")
            if obj == "damped":
                snr_s, dstats = stream_damped_decode(port, tmp, "mesh", stream_sig, res)[:2]
                if (abs(snr_s - STREAM_DAMPED_SNR_DB) > SNR_TOL_DB
                        or dstats["iterations"] != STREAM_DAMPED_ITERATIONS):
                    raise AssertionError(f"mesh stream damped: {snr_s} dB, {dstats}")
            else:
                prec, pbank = _prune_streamed(res[0], stream_sig, res[4], res[3], res[5])
                snr_s = port.compute_snr(stream_sig, port.decompress_audio(
                    prec, pbank, res[2], res[3], original_len=res[7], device="cuda"))
                if abs(snr_s - STREAM_BALANCED_SNR_DB) > SNR_TOL_DB:
                    raise AssertionError(f"mesh stream balanced: {snr_s} dB")
            case.update(cells=4, devices=which, equal_to_single=True, snr_db=snr_s)

    # a packed stack of 16 ten-second files over the 4 cells of (2, 2)
    ten = packed_signals(10.0, PACK_FILES)
    one = port.compress_audio_packed(ten, 44100, 2, device="cuda")
    res, case = run("packed 16 x 10 s over (2, 2)",
                    lambda: port.compress_audio_packed(ten, 44100, 2, mesh=mesh),
                    {"search_scan": 4, "refine_window": 4, "window_stats": 4, "bank_means": 1},
                    lambda: port.compress_audio_packed(ten, 44100, 2, device="cuda"))
    if not all(same_result(a, b) for a, b in zip(res, one)):
        raise AssertionError("mesh packed: a file differs from the single-device stack")
    case.update(cells=4, devices=which, equal_to_single=True)

    # the damped decode over dp 4: each slab as it decodes alone
    mesh4, which4 = mesh_of(4, 1)
    rec, bank, n_ranges, rs, *_ = singles["damped"]
    kw = dict(original_len=len(sig), s_damping=0.25)
    stats = {}
    recon, case = run("10 s damped decode over dp 4",
                      lambda: port.decompress_audio(rec, bank, n_ranges, rs, mesh=mesh4,
                                                    stats=stats, **kw),
                      {}, lambda: port.decompress_audio(rec, bank, n_ranges, rs,
                                                        device="cuda", **kw))
    mloc = pad_to(bucket(n_ranges, 256), 4 * 256) // 4
    slabs, its = [], []
    for a in range(0, n_ranges, mloc):
        st = {}
        r = rec[a : a + mloc]
        slabs.append(port.decompress_audio(r, bank, len(r), rs, s_damping=0.25,
                                           device="cuda", stats=st))
        its.append(st["iterations"])
    if not np.array_equal(recon, np.concatenate(slabs)[: len(sig)]):
        raise AssertionError("mesh decode: differs from the slabs decoded alone")
    snr_dp = port.compute_snr(sig, recon)
    if (abs(snr_dp - DAMPED_RECORDS_SNR_DB) > MESH_DECODE_SNR_TOL_DB
            or stats["iterations"] != max(its)):
        raise AssertionError(f"mesh decode: {snr_dp} dB, {stats}, slabs {its}")
    case.update(cells=4, devices=which4, slab_iterations=its, snr_db=snr_dp)

    # the CLI: missing cards fail the file (exit 1), as in the JAX CLI; on
    # one card the repeated mesh goes through the API and writes the same v1
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        wav = d / "bench10.wav"
        port.write_wav(wav, sig, 44100, 2)
        from fwav_tpu_torch import cli

        argv = ["compress", str(wav), str(d / "m.fwav"), "--devices", "2", "--tp", "2"]
        if torch.cuda.device_count() < 2:
            rc = cli.main(argv)
            err = codec.process_file_compress(str(wav), str(d / "m.fwav"), devices=2, tp=2)
            if rc != 1 or (d / "m.fwav").exists() or "requested 2 devices but only" not in \
                    err.get("error", ""):
                raise AssertionError(f"mesh cli: exit {rc}, {err}")
            cli_result = {"exit_code": rc, "error": err["error"]}
        else:
            if cli.main(argv) != 0 or (d / "m.fwav").read_bytes() != api_files["default"]:
                raise AssertionError("mesh cli: --devices 2 --tp 2 differs from the API's file")
            cli_result = {"exit_code": 0, "file_equal_to_api": True}
        mesh12, _ = mesh_of(1, 2)
        signal = port.read_wav_mono(wav)[0]
        r, b, nr, rs2, tile, step, thr, olen = compress_audio_sharded(signal, 44100, 2,
                                                                      mesh=mesh12)
        pr, pb = port.prune_bank(r, b)
        port.save_compressed(d / "api.fwav", pr, pb, rs2, 44100, 2, tile, step, thr, olen)
        if (d / "api.fwav").read_bytes() != api_files["default"]:
            raise AssertionError("mesh api: the (1, 2) mesh's v1 differs from the slice's")
        cli_result["api_file_equal"] = True

    reports = loopback(kernels)
    for case in cases:
        case["launches_per_cell"] = {k: v / case["cells"] for k, v in case["launches"].items()
                                     if v}
    emit({"phase": "mesh", "card": smi, "cuda_device_count": torch.cuda.device_count(),
          "cases": cases, "launches": total, "cli": cli_result, "loopback": reports,
          "snr_db": {"default": snr, "damped_records": snr_d}})
    return {"mesh": total}


#: Host-clock calls of the 10 s encode with and without a collector.
TRACE_OVERHEAD_CALLS = 12


def _phase_ms(phases) -> dict:
    return {k: v * 1e3 for k, v in sorted(phases.items())}


def trace_phase(port, kernels, smi, sig, stream_sig):
    """The phase table of fwav_tpu_torch/utils/trace.py on the card: the
    10 s main path (default and damped) with TRACE_KEYS' keys and the JAX
    nesting, a packed stack of 16 (its files refit on the card), the
    100 s stream (each phase its `stats` sum), a torch_profile trace of the
    default encode (every phase range and K1's and K2's kernels in it, the
    card's busy time beside the phases), busy_ms inside and outside a
    collector (the same device records, no range among them), the
    collector's overhead, and examples/torch_round_trip.py on the card.
    Returns the launch counts of the default encode."""
    import io
    import runpy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fwav_tpu_torch.utils import collect_phases, torch_profile

    out, report = {}, {"phase": "trace", "card": smi}
    for name, kw in (("default", {}), ("damped", {"objective": "damped"})):
        port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)  # warm
        kernels.reset_launch_counts()
        with collect_phases() as ph:
            t0 = time.perf_counter()
            port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if sorted(ph) != port_keys(name):
            raise AssertionError(f"trace {name}: keys {sorted(ph)}, not {port_keys(name)}")
        if not (ph["device"] >= ph["d2h"] >= ph["host_bank"] > 0
                and ph["device"] + ph["refit"] <= wall):
            raise AssertionError(f"trace {name}: the phases do not nest: {ph}, wall {wall}")
        scan = "topc_scan" if kw else "search_scan"
        need(f"trace {name}", launches, {scan: 1, "refine_window": 1, "window_stats": 1})
        if name == "default":
            out["trace"] = launches
        report[name] = {"phases_ms": _phase_ms(ph), "wall_ms": wall * 1e3,
                        "launches": launches}

    # packed: the 16 files of the packed phase, refit on the card in one launch; the
    # host half's `refit` (the records' view) once per file
    stack = packed_signals(10.0, PACK_FILES)
    port.compress_audio_packed(stack, 44100, 2, device="cuda")  # warm
    kernels.reset_launch_counts()
    with collect_phases() as ph:
        port.compress_audio_packed(stack, 44100, 2, device="cuda")
    if sorted(ph) != port_keys("packed"):
        raise AssertionError(f"trace packed: keys {sorted(ph)}")
    refits = dict(kernels.REFITS)
    if (refits != {"device": PACK_FILES, "host": 0} or kernels.LAUNCHES["collect_refit"] != 1
            or not ph["refit"] > 0):
        raise AssertionError(f"trace packed: refit {ph['refit']}, files {refits}, "
                             f"launches {kernels.LAUNCHES['collect_refit']}")
    if not ph["device"] >= ph["d2h"] >= ph["host_bank"] > 0:
        raise AssertionError(f"trace packed: the phases do not nest: {ph}")
    report["packed"] = {"files": PACK_FILES, "phases_ms": _phase_ms(ph), "refits": refits}

    # the 100 s stream: phases and stats read one clock
    for name, kw in (("stream_damped", {"objective": "damped"}), ("stream_balanced", {})):
        stats = {}
        with collect_phases() as ph:
            port.compress_audio_streaming(stream_sig, 44100, 2, device="cuda", stats=stats,
                                          **kw)
        if sorted(ph) != port_keys(name):
            raise AssertionError(f"trace {name}: keys {sorted(ph)}, not {port_keys(name)}")
        shards = stats["shards"]

        def total(key, shards=shards):
            return sum(sh[key] for sh in shards) / 1e3

        want = {"vad": stats["vad_ms"] / 1e3,
                "dispatch": total("h2d_ms") + total("enqueue_ms"),
                "fetch_wait": total("wait_ms"), "host_refit": total("refit_ms")}
        if "global_pass" in stats:
            gp = stats["global_pass"]
            want.update(global_h2d=gp["h2d_ms"] / 1e3, global_dispatch=gp["enqueue_ms"] / 1e3,
                        global_fetch=gp["wait_ms"] / 1e3,
                        global_pass=(gp["h2d_ms"] + gp["enqueue_ms"] + gp["wait_ms"]) / 1e3,
                        global_refit=gp["refit_ms"] / 1e3)
        bad = {k: (ph[k], v) for k, v in want.items() if abs(ph[k] - v) > 1e-9 * max(v, 1e-3)}
        if set(want) != set(ph) - {"prep", "shard_prep"} or bad:
            raise AssertionError(f"trace {name}: phases differ from stats: {bad}")
        report[name] = {"shards": len(shards), "phases_ms": _phase_ms(ph)}

    # a profiler trace of the default encode: every phase range, K1, K2
    with tempfile.TemporaryDirectory() as tmp:
        with counted_replays() as graphs:
            with collect_phases() as ph, padded(torch_profile(tmp)) as (prof, ns):
                port.compress_audio_arrays(sig, 44100, 2, device="cuda")
        files = list(Path(tmp).glob("*.json"))
        if len(files) != 1:
            raise AssertionError(f"trace: torch_profile wrote {files}")
        trace_bytes = files[0].stat().st_size
    names = {e.name for e in prof.events()}
    recs, _, lost = device_work(prof, ns, graphs)
    kernel_names = {e.name() for e in recs}
    missing = [f"phase.{k}" for k in TRACE_KEYS["default"] if f"phase.{k}" not in names]
    for kname in ("search_scan_kernel", "refine_window_kernel", "window_stats_kernel",
                  "bank_means_kernel"):
        if not any(kname in n for n in kernel_names):
            missing.append(kname)
    if missing:
        raise AssertionError(f"trace: the profiler trace lacks {missing}")
    report["profile"] = {"trace_file_bytes": trace_bytes, "phases_ms": _phase_ms(ph),
                         "busy_ms": sum(e.duration_ns() for e in recs) / 1e6,
                         "device_events": len(recs), "records_lost": lost,
                         "graph_launches": graphs["launches"], "graph_nodes": graphs["nodes"]}

    # busy_ms inside and outside a collector: the same work on the card, the
    # same records of it wherever the profiler lost none, and the ranges it
    # drops are annotations only
    with collect_phases():
        inside = busy_ms(lambda: port.compress_audio_arrays(sig, 44100, 2, device="cuda"))
    outside = busy_ms(lambda: port.compress_audio_arrays(sig, 44100, 2, device="cuda"))
    with padded(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) as (prof, _):
        port.compress_audio_arrays(sig, 44100, 2, device="cuda")
    raw = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    kept = {e.name for e in device_events(prof)}
    dropped = raw - kept
    same_records = inside[3] == outside[3] or inside[5] or outside[5]
    if (inside[4] != outside[4] or not same_records
            or any(n.startswith(USER_RANGES) for n in kept)
            or not all(n.startswith(USER_RANGES) for n in dropped)):
        raise AssertionError(f"trace: busy_ms counts {inside[3]} / {outside[3]} records of "
                             f"{inside[4]} / {outside[4]} calls, {inside[5]} / {outside[5]} "
                             f"lost; dropped {sorted(dropped)}")
    report["busy_ms"] = {"in_collector": inside[1], "without": outside[1],
                         "device_events": inside[3], "device_calls": inside[4],
                         "records_lost": [inside[5], outside[5]],
                         "annotations_dropped": sorted(dropped)}

    # the collector's overhead on the host clock (no limit: the host clock
    # moves by a third between calls)
    with_c, without, tables = [], [], []
    for _ in range(TRACE_OVERHEAD_CALLS):
        t0 = time.perf_counter()
        port.compress_audio_arrays(sig, 44100, 2, device="cuda")
        without.append(time.perf_counter() - t0)
        with collect_phases() as ph:
            t0 = time.perf_counter()
            port.compress_audio_arrays(sig, 44100, 2, device="cuda")
            with_c.append(time.perf_counter() - t0)
        tables.append(ph)
    report["overhead"] = {"calls": TRACE_OVERHEAD_CALLS,
                          "median_ms_with_collector": statistics.median(with_c) * 1e3,
                          "median_ms_without": statistics.median(without) * 1e3,
                          "phases_ms_median": {k: statistics.median(t[k] for t in tables) * 1e3
                                               for k in TRACE_KEYS["default"]}}

    # the port's round-trip example, on the card by default
    path = Path(__file__).resolve().parent / "examples" / "torch_round_trip.py"
    argv, buf = sys.argv, io.StringIO()
    kernels.reset_launch_counts()
    try:
        sys.argv = [str(path)]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    text = buf.getvalue()
    line = [ln for ln in text.splitlines() if ln.startswith("round-trip SNR")]
    if not line or kernels.LAUNCHES["search_scan"] + kernels.LAUNCHES["topc_scan"] < 1:
        raise AssertionError(f"examples/torch_round_trip.py: {text[-2000:]} "
                             f"{kernels.LAUNCHES}")
    report["example"] = {"output": line[0], "launches": dict(kernels.LAUNCHES)}
    emit(report)
    return out


if __name__ == "__main__":
    sys.exit(main())
