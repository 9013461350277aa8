#!/usr/bin/env python3
"""Time K2 (the dense window refine) of two checkouts on one card, in turns.

    python3 scripts/compare_refine_kernel.py OLD_DIR NEW_DIR

Runs OLD, NEW, NEW, OLD, each in its own process from its directory (so
each builds and imports its own fwav_tpu_torch), on chip_smoke.py's inputs
at the shapes it checks: the 10 s encode's box-mean sequence with 114,688
ranges and one shard window's with 262,144; one seeded lobe per range
(balanced, affine, damped) and K3's four lobes per range (damped and
balanced; chip_smoke.k2_lobe_matrix). A checkout whose refine_window takes
one lobe per range and launch (no `window_stats`) runs the four lobes as
its encoder did: one launch per lobe column and the strict `>` merge in
torch between them. A checkout with `window_stats` runs one call, timed
whole (`k2_*`: the table and the scoring launch), and the scoring launch
alone on a table made before (`k2_score_*`), the table alone
(`k2_stats_*`), and for one lobe per range the scoring launch with the
ranges reordered so that their lobes ascend (`k2_score_sorted_*`: what
the same kernel takes when neighbouring ranges share their windows, the
reuse that grouping ranges by lobe would buy). Inputs and timer (chip_smoke.graph_ms: 10 back-to-back
calls captured in a CUDA graph, the median of 20 replays by CUDA events, so
that the host's launch time is not counted) come from this script's own
checkout. Prints one JSON line per run and the card's name and power
limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

TIMER = r"""
import importlib.util, json, sys, numpy as np, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
from bench import make_signal
from fwav_tpu_torch.models import encode as enc
from fwav_tpu_torch.ops import kernels

dev = torch.device("cuda")
single_launch = hasattr(kernels, "window_stats")
stride, block_len = 128, 256


def per_lobe(means_ext, lobes, ranges, *rest):
    best_s = torch.full((ranges.shape[0],), float("-inf"), device=dev)
    best_i = torch.zeros(ranges.shape[0], dtype=torch.int32, device=dev)
    for c in range(lobes.shape[1]):
        s_k, i_k = kernels.refine_window(means_ext, lobes[:, c], ranges, *rest)
        take = s_k > best_s
        best_s = torch.where(take, s_k, best_s)
        best_i = torch.where(take, i_k, best_i)
    return best_s, best_i


def time_k2(res, name, k2):
    lobes = k2[1]
    if hasattr(kernels, "check_refine_lead"):  # K2 reads n_valid from device memory
        k2 = (*k2[:3], chip_smoke.device_counts(k2[3], dev), *k2[4:])
    if not single_launch and lobes.dim() == 2:
        res["k2_" + name] = chip_smoke.graph_ms(lambda: per_lobe(*k2))
        return
    res["k2_" + name] = chip_smoke.graph_ms(lambda: kernels.refine_window(*k2))
    if single_launch:
        table = (k2[0], int(k2[2].shape[1]), k2[5], k2[6])
        stats = kernels.window_stats(*table)
        res["k2_score_" + name] = chip_smoke.graph_ms(
            lambda: kernels.refine_window(*k2, stats=stats))
        res["k2_stats_" + name] = chip_smoke.graph_ms(lambda: kernels.window_stats(*table))
        if lobes.dim() == 1:
            order = torch.argsort(lobes, stable=True)
            by_lobe = (k2[0], lobes[order].contiguous(), k2[2][order].contiguous(), *k2[3:])
            res["k2_score_sorted_" + name] = chip_smoke.graph_ms(
                lambda: kernels.refine_window(*by_lobe, stats=stats))


res = {}
sig10, sig100 = make_signal(10.0), make_signal(100.0)[:1572864]
for tag, sig, M, D, n_valid, seeds in (("", sig10, 114688, 3584, 439977, (2, 3)),
                                        ("shard_", sig100, 262144, 12288,
                                         1572864 - 1024 + 1, (5, 7))):
    raw_norm = torch.from_numpy(sig / np.abs(sig).max()).to(dev)
    means_ext, _ = enc._means_setup(raw_norm, 4, block_len, stride, D)
    rng = np.random.default_rng(seeds[0])
    lobes = torch.from_numpy(rng.integers(-1, D - 3, M).astype(np.int32)).to(dev)
    ranges = torch.from_numpy(rng.standard_normal((M, 4)).astype(np.float32) * 0.3).to(dev)
    for objective in ("balanced", "affine", "damped"):
        time_k2(res, tag + objective,
                (means_ext, lobes, ranges, n_valid, stride, block_len, objective, 16.0))
    for objective in ("damped", "balanced"):
        lobes4 = chip_smoke.k2_lobe_matrix(kernels, dev, seeds[1], M, D, objective,
                                           n_valid, stride)
        time_k2(res, tag + "lobes4_" + objective,
                (means_ext, lobes4, ranges, n_valid, stride, block_len, objective, 16.0))
print(json.dumps(res))
"""


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    for i, (tag, cwd) in enumerate((("old", old), ("new", new), ("new", new), ("old", old))):
        out = subprocess.run([sys.executable, "-c", TIMER, str(CHIP_SMOKE)], cwd=cwd,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        times = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": tag, "dir": str(cwd), "ms": times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
