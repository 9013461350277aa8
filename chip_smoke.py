#!/usr/bin/env python3
"""Smoke run of fwav_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py        # from the repository root

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of fwav_tpu_torch/csrc; any ptxas
   spill fails the run;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 10 s main paths (and K1 at the exact branch's largest
   bank) and of the 100 s stream (K1, K3 and K2 at a shard's shapes, K3 at
   the global pass's whole-file shape), held to the near-tie bar of
   fwav_tpu_torch/ops/near_tie.py (K2, with one lobe per range and with
   K3's four, and its per-position table to exact equality), with
   CUDA-event times of both, the kernel's bound (bytes, tensor work and
   CUDA-core operations of these inputs at the card's published peaks)
   and its share of it;
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
   pass: K3 over every range of the file and the staged window refine;
   the streaming prune, v2 with the hint, the decode loop at the stored
   hint), the same without the pass (it must gain more than 3 dB), and
   balanced (K1 then K2 per shard; the unpruned bank through the streaming
   v1 writer, the closed-form decode): the JAX package's sentinels, SNR,
   iterations and bytes, encode x-realtime, per-shard phase times, the
   encode's device time with and without the pass (torch.profiler; the
   pass's is the difference), decode time, peak memory; then the 12 s
   fixture of tests/test_torch_stream.py on the card against the host's
   plain run.

Each slice runs with the launch counts set to 0 just before it and read
just after; a kernel of the slice that was not launched fails the run.
The last lines are the nvidia-smi line, a JSON summary of the kernels, and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

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
    launch them, which kernel_ms would time as the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps=reps) / inner


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


def scan_bound(M, N, n_valid, D, out_bytes_per_range, clip) -> dict:
    """K1/K3 at M ranges x n_valid valid domains (of D): the screen on the
    CUDA cores, the numerators on the tensor cores, the ranges, bank and
    outputs once."""
    pairs = M * n_valid
    ops = SCAN_EPILOGUE_OPS["clip" if clip else "sqrt"]
    nbytes = M * N * 4 + D * (N * 4 + 4 + 1 + (4 if clip else 0)) + M * out_bytes_per_range
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

    means_ext, lobes, ranges, _, stride, block_len, objective, _ = k2
    N = int(ranges.shape[1])
    check = near_tie.check_argmax(name, kernels.refine_window(*k2),
                                  kernels.refine_window_ref(*k2))
    if check["idx_diff"] or check["max_abs_err"]:
        raise AssertionError(f"{name}: the kernel and its plain version differ: {check}")
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
                          if re.search(r"ILi4E", k) or "merge" in k}}


def kernel_inputs(dev, seed: int, M: int, D: int, objective: str):
    """Seeded K1 inputs: centered ranges, a bank and its weights."""
    import numpy as np
    import torch

    from fwav_tpu_torch.ops.affine import affine_stats
    from fwav_tpu_torch.ops.search import domain_thresh, domain_weights

    rng = np.random.default_rng(seed)
    r = rng.standard_normal((M, 4)).astype(np.float32) * 0.3
    bank = rng.standard_normal((D, 4)).astype(np.float32) * 0.3
    r_c = torch.from_numpy(r - r.mean(1, keepdims=True)).to(dev)
    bank_t = torch.from_numpy(bank).to(dev)
    mean, denom = affine_stats(bank_t)
    valid = torch.arange(D, device=dev) < D - 37
    return (r_c, bank_t.T.contiguous(), domain_weights(mean, denom, 4, objective),
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
    from fwav_tpu_torch.models import encode as enc
    from fwav_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    emit({"phase": "build", "seconds": build_s, "library": str(lib_path),
          "ptxas": ptxas_summary(log) if log else "up to date"})

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
    for key, val in checks.items():
        emit({"phase": "kernel", "check": key, "card": smi, **val})

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
    mode, st = enc._plan_search(cfg, lb // cfg.range_size, db)
    raw = torch.from_numpy(raw_p).to(dev)
    core_span_ms = cuda_ms(
        lambda: enc.encode_core(raw, len(signal), nr, nd, lb, db, cfg, mode, st), reps=5
    )
    emit({"phase": "slice", "card": smi, "seconds_audio": len(signal) / sr,
          "n_ranges": n_ranges, "sentinels": sentinels, "snr_db": snr,
          "launches": launches, "idx_diff_vs_host": cpu_diff,
          "fwav_bytes": fwav_bytes, "encode_s_median5": enc_s,
          "x_realtime": len(signal) / sr / enc_s, "core_span_ms_median5": core_span_ms,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})

    damped_launches = damped_slice(port, kernels, enc, dev, smi, signal, sr, sw)
    by_path = {"balanced": launches, "damped": damped_launches,
               **stream_phase(port, kernels, smi, stream_sig)}

    def summary(key, prefix, main_check):
        """Launches of every path; times and bound at the main path's
        shape; the largest error of all checks."""
        err = max(v["max_abs_err"] for k, v in checks.items() if k.startswith(prefix))
        main = checks[main_check]
        return {"launches": sum(p[key] for p in by_path.values()),
                "launches_by_path": {name: p[key] for name, p in by_path.items()},
                "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "bound_term": main["bound_term"], "share_of_bound": main["share_of_bound"],
                "library_ms": None, "library_note": LIBRARY_NOTE, "card": smi}

    print(smi, flush=True)
    emit({"kernels": [
        {"name": "search_scan (K1)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/search_scan.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:67",
         **summary("search_scan", "k1_", "k1_coarse")},
        {"name": "refine_window (K2)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/refine_window.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:301",
         **summary("refine_window", "k2_", "k2_balanced")},
        {"name": "window_stats (K2's per-position table)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/refine_window.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:301",
         **summary("window_stats", "ws_", "ws_balanced")},
        {"name": "topc_scan (K3)", "route": "cuda",
         "source": "fwav_tpu_torch/csrc/topc_scan.cu",
         "replaces": "fwav_tpu/ops/pallas_search.py:141",
         **summary("topc_scan", "k3_", "k3_damped")},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def damped_slice(port, kernels, enc, dev, smi, signal, sr, sw):
    """The damped profile's main path on the card, held to the JAX CPU
    run's numbers and to the host run; returns its launch counts."""
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
    mode, st = enc._plan_search(cfg, lb // cfg.range_size, db)
    raw = torch.from_numpy(raw_p).to(dev)
    core_span_ms = cuda_ms(
        lambda: enc.encode_core(raw, len(signal), nr, nd, lb, db, cfg, mode, st), reps=5
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
    return launches


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
    for objective in ("balanced", "damped"):
        k2 = (means_ext, lobes, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_shard_{objective}"] = k2_check(kernels, f"K2 shard {objective}", k2,
                                                   plain_reps=5)
        checks[f"ws_shard_{objective}"] = stats_check(
            kernels, f"K2 table shard {objective}", means_ext, 4, block_len, objective)
        lobes4 = k2_lobe_matrix(kernels, dev, 7, M1, D1, objective, n_valid, stride)
        k2 = (means_ext, lobes4, ranges, n_valid, stride, block_len, objective, 16.0)
        checks[f"k2_shard_lobes4_{objective}"] = k2_check(
            kernels, f"K2 shard 4 lobes {objective}", k2, plain_reps=3, plain_warmup=1)


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
    card's busy time (the summed durations of its kernels and copies, ms)
    beside the profiled run's host-clock seconds. The kernels launched
    through ctypes are not attributed to the `stream.*` ranges, so a
    phase's busy time is taken as the difference of two encodes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = port.compress_audio_streaming(sig, 44100, 2, device="cuda", **kw)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.name.startswith("stream.")]
    return res, {"profiled_wall_s": wall, "device_events": len(dev),
                 "device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3}


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
                                            launches["window_stats"]) < 5:
            raise AssertionError(f"the damped stream did not launch K3 x6 and K2 x5: {launches}")
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
                "global_pass_device_ms": prof["device_ms"] - prof_off["device_ms"]}
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
        if min(launches[k] for k in ("search_scan", "refine_window", "window_stats")) < 5:
            raise AssertionError(f"the balanced stream did not launch K1 x5 and K2 x5: {launches}")
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


if __name__ == "__main__":
    sys.exit(main())
