#!/usr/bin/env python3
"""Smoke run of fwav_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py        # from the repository root

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of fwav_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 10 s main paths (and K1 at the exact branch's largest
   bank) and of the 100 s stream (K1, K3 and K2 at a shard's shapes, K3 at
   the global pass's whole-file shape), with CUDA-event times of both;
4. slice: 10 s of 44.1 kHz 16-bit mono through the public API on the card
   (WAV write/read, compress_audio_arrays, prune_bank, save/load,
   decompress_audio): K1 and K2 launched, the sentinel count and the
   round-trip SNR of the JAX package's run, warm encode time;
5. damped: the damped profile's main path on the same file (encode with
   objective="damped": K3 once, K2 once per lobe; prune_bank; the v2
   container with the decode hint; load; the decode loop at the stored
   hint): the JAX package's sentinels, SNR and iteration count, the host
   run's records, bytes, warm encode time, decode time, peak memory;
6. stream: 100 s of bench.make_signal(100.0) through
   compress_audio_streaming at the default shard and halo (5 shards):
   damped (K3 then K2 per lobe in every shard, then the whole-file global
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
#: Kernel vs plain bar (tests/test_pallas_search.py's): identical -inf sets;
#: at most 2 differing idx per 1,024 rows, each a near-tie whose scores
#: agree to this relative tolerance.
NEAR_TIE_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, want):
    """Hold a kernel's (score, idx) to its plain version's; returns the
    numbers of the check."""
    import numpy as np

    s_k, i_k = (x.cpu().numpy() for x in got)
    s_p, i_p = (x.cpu().numpy() for x in want)
    fin = np.isfinite(s_p)
    if not np.array_equal(np.isfinite(s_k), fin):
        raise AssertionError(f"{name}: the -inf sets differ")
    diff = np.nonzero(fin & (i_k != i_p))[0]
    if len(diff) > 2 * -(-len(i_p) // 1024):
        raise AssertionError(f"{name}: {len(diff)} idx differ")
    if not np.allclose(s_k[diff], s_p[diff], rtol=NEAR_TIE_RTOL, atol=0):
        raise AssertionError(f"{name}: idx differ where the scores do not tie")
    err = float(np.max(np.abs(s_k[fin] - s_p[fin]))) if fin.any() else 0.0
    return {"rows": int(len(i_p)), "idx_diff": int(len(diff)),
            "finite": int(fin.sum()), "max_abs_err": err}


def compare_lists(name, got, want):
    """Hold K3's lobe lists to its plain version's: equal, -1 included."""
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the top-C lists differ")
    return {"rows": int(got.shape[0]), "idx_diff": 0,
            "unfilled": int((want < 0).sum()), "max_abs_err": 0.0}


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
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "entry function" in ln]})

    # --- kernels vs plain, at main-path shapes ----------------------------
    checks = {}
    M, D = 114688, 3584  # 10 s: padded ranges x stride-128 subsampled bank
    args = kernel_inputs(dev, 0, M, D, "balanced")
    got = kernels.search_scan(*args[:4])
    want = kernels.search_scan_ref(*args[:4], range_block=16384)
    checks["k1_coarse"] = {
        **compare("K1 coarse", got, want), "shape": [M, D],
        "ms": cuda_ms(lambda: kernels.search_scan(*args[:4])),
        "plain_ms": cuda_ms(lambda: kernels.search_scan_ref(*args[:4], range_block=16384)),
    }
    M2, D2 = 8192, 24576  # exact branch: the largest bank bucket under 32,768
    args2 = kernel_inputs(dev, 1, M2, D2, "damped")
    got = kernels.search_scan(*args2, s_clip=16.0)
    want = kernels.search_scan_ref(*args2, s_clip=16.0, range_block=8192)
    checks["k1_exact_damped"] = {
        **compare("K1 exact damped", got, want), "shape": [M2, D2],
        "ms": cuda_ms(lambda: kernels.search_scan(*args2, s_clip=16.0)),
        "plain_ms": cuda_ms(lambda: kernels.search_scan_ref(*args2, s_clip=16.0,
                                                            range_block=8192)),
    }
    sig = make_signal(10.0)
    raw_norm = torch.from_numpy(sig / np.abs(sig).max()).to(dev)
    n_valid, stride, block_len = 439977, 128, 256
    means_ext, _ = enc._means_setup(raw_norm, 4, block_len, stride, D)
    rng = np.random.default_rng(2)
    lobes = torch.from_numpy(rng.integers(-1, D - 3, M).astype(np.int32)).to(dev)
    ranges = torch.from_numpy(rng.standard_normal((M, 4)).astype(np.float32) * 0.3).to(dev)
    for objective in ("balanced", "affine", "damped"):
        k2 = (means_ext, lobes, ranges, n_valid, stride, block_len, objective, 16.0)
        got = kernels.refine_window(*k2)
        want = kernels.refine_window_ref(*k2)
        checks[f"k2_{objective}"] = {
            **compare(f"K2 {objective}", got, want), "shape": [M, int(means_ext.shape[0])],
            "ms": cuda_ms(lambda: kernels.refine_window(*k2)),
            "plain_ms": cuda_ms(lambda: kernels.refine_window_ref(*k2)),
        }
    args3 = {obj: kernel_inputs(dev, 3, M, D, obj) for obj in ("damped", "balanced")}
    for obj, a in args3.items():
        k3 = (*a[:4], 4, a[4], 16.0)
        got = kernels.topc_scan(*k3)
        want = kernels.topc_scan_ref(*k3, range_block=16384)
        checks[f"k3_{obj}"] = {
            **compare_lists(f"K3 {obj}", got, want), "shape": [M, D, 4],
            "ms": cuda_ms(lambda: kernels.topc_scan(*k3)),
            "plain_ms": cuda_ms(lambda: kernels.topc_scan_ref(*k3, range_block=16384)),
        }
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
    if launches["search_scan"] < 1 or launches["refine_window"] < 1:
        raise AssertionError(f"the slice did not launch K1 and K2: {launches}")
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
        """Launches of both main paths; times at the main path's shape; the
        largest error of all checks."""
        err = max(v["max_abs_err"] for k, v in checks.items() if k.startswith(prefix))
        return {"launches": sum(p[key] for p in by_path.values()),
                "launches_by_path": {name: p[key] for name, p in by_path.items()},
                "max_abs_err": err, "ms": checks[main_check]["ms"],
                "plain_ms": checks[main_check]["plain_ms"]}

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
    if launches["topc_scan"] < 1 or launches["refine_window"] < 4:
        raise AssertionError(f"the damped slice did not launch K3 and K2 x4: {launches}")
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
    a = kernel_inputs(dev, 6, M1, D1, "balanced")
    checks["k1_shard_balanced"] = {
        **compare("K1 shard balanced", kernels.search_scan(*a[:4]),
                  kernels.search_scan_ref(*a[:4], range_block=16384)),
        "shape": [M1, D1],
        "ms": cuda_ms(lambda: kernels.search_scan(*a[:4])),
        "plain_ms": cuda_ms(lambda: kernels.search_scan_ref(*a[:4], range_block=16384),
                            reps=3, warmup=1),
    }
    a = kernel_inputs(dev, 7, M1, D1, "damped")
    k3 = (*a[:4], 4, a[4], 16.0)
    checks["k3_shard_damped"] = {
        **compare_lists("K3 shard damped", kernels.topc_scan(*k3),
                        kernels.topc_scan_ref(*k3, range_block=16384)),
        "shape": [M1, D1, 4],
        "ms": cuda_ms(lambda: kernels.topc_scan(*k3)),
        "plain_ms": cuda_ms(lambda: kernels.topc_scan_ref(*k3, range_block=16384),
                            reps=3, warmup=1),
    }

    M, D = 1310720, 10240  # 100 s: padded ranges x stride-512 whole-file rows
    a = kernel_inputs(dev, 4, M, D, "damped")
    k3 = (*a[:4], 4, a[4], 16.0)
    got = kernels.topc_scan(*k3)
    want = kernels.topc_scan_ref(*k3, range_block=32768)
    checks["k3_global_damped"] = {
        **compare_lists("K3 global", got, want), "shape": [M, D, 4],
        "ms": cuda_ms(lambda: kernels.topc_scan(*k3)),
        "plain_ms": cuda_ms(lambda: kernels.topc_scan_ref(*k3, range_block=32768),
                            reps=3, warmup=1),
    }
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
        checks[f"k2_shard_{objective}"] = {
            **compare(f"K2 shard {objective}", kernels.refine_window(*k2),
                      kernels.refine_window_ref(*k2)),
            "shape": [M1, int(means_ext.shape[0])],
            "ms": cuda_ms(lambda: kernels.refine_window(*k2)),
            "plain_ms": cuda_ms(lambda: kernels.refine_window_ref(*k2), reps=5),
        }


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
        if launches["topc_scan"] < 6 or launches["refine_window"] < 20:
            raise AssertionError(f"the damped stream did not launch K3 x6 and K2 x20: {launches}")
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
        if launches["search_scan"] < 5 or launches["refine_window"] < 5:
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
