#!/usr/bin/env python3
"""Time K1 and K3 of two checkouts of the repository on one card, in turns.

    python3 scripts/compare_scan_kernels.py OLD_DIR NEW_DIR [--wide-only | --encode-tile T]

Runs OLD, NEW, NEW, OLD, each in its own process from its directory (so
each builds and imports its own fwav_tpu_torch), on chip_smoke.py's seeded
inputs at the shapes it checks: K1 at 114,688 x 3,584 (balanced), 8,192 x
24,576 (damped, the exact branch) and 262,144 x 12,288 (balanced, a
shard); K3 (C = 4) at 114,688 x 3,584 (damped and balanced), 262,144 x
12,288 and 1,310,720 x 10,240 (damped); then the wide kernels (range sizes
17-255) at every shape of chip_smoke.WIDE_CHECKS, on the inputs of
chip_smoke.wide_kernel_checks. `--wide-only` times the wide shapes alone;
`--encode-tile T` instead times the K1 and K3 calls of one 10 s encode at
tile T, balanced and damped, on that encode's own inputs
(chip_smoke.encode_scan_calls).
Both runs take their inputs and their timer (chip_smoke.kernel_ms: the
median over 20 samples of 10 back-to-back launches, by CUDA events) from
this script's own checkout. Prints one JSON line per run and the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

TIMER = r"""
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
kernel_inputs, kernel_ms = chip_smoke.kernel_inputs, chip_smoke.kernel_ms
from fwav_tpu_torch.ops import kernels

dev = torch.device("cuda")
res = {}
if sys.argv[2] == "--encode-tile":
    tile = int(sys.argv[3])
    for obj in ("balanced", "damped"):
        for i, (name, args, kw) in enumerate(chip_smoke.encode_scan_calls(tile, obj)):
            fn = getattr(kernels, name)
            res[f"enc{tile}_{obj}_{name}{i}_N{args[0].shape[-1]}"] = kernel_ms(
                lambda: fn(*args, **kw))
    print(json.dumps(res))
    sys.exit(0)
narrow = sys.argv[2] != "--wide-only"
for name, seed, M, D, obj in narrow * (("k1_coarse", 0, 114688, 3584, "balanced"),
                              ("k1_exact_damped", 1, 8192, 24576, "damped"),
                              ("k1_shard_balanced", 6, 262144, 12288, "balanced")):
    a = kernel_inputs(dev, seed, M, D, obj)
    args, kw = (a, {"s_clip": 16.0}) if obj == "damped" else (a[:4], {})
    res[name] = kernel_ms(lambda: kernels.search_scan(*args, **kw))
for name, seed, M, D, obj in narrow * (("k3_damped", 3, 114688, 3584, "damped"),
                              ("k3_balanced", 3, 114688, 3584, "balanced"),
                              ("k3_shard_damped", 7, 262144, 12288, "damped"),
                              ("k3_global_damped", 4, 1310720, 10240, "damped")):
    a = kernel_inputs(dev, seed, M, D, obj)
    res[name] = kernel_ms(lambda: kernels.topc_scan(*a[:4], 4, a[4], 16.0))
for name, scan, N, M, D, obj in chip_smoke.WIDE_CHECKS:
    a = kernel_inputs(dev, 500 + N, M, D, obj, N=N)
    if scan == "search_scan":
        args, kw = (a, {"s_clip": 16.0}) if obj == "damped" else (a[:4], {})
        res[name] = kernel_ms(lambda: kernels.search_scan(*args, **kw))
    else:
        res[name] = kernel_ms(lambda: kernels.topc_scan(*a[:4], 4, a[4], 16.0))
print(json.dumps(res))
"""


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    only = sys.argv[3:] or ["all"]
    if only[0] not in ("all", "--wide-only", "--encode-tile") or \
            len(only) != (2 if only[0] == "--encode-tile" else 1):
        raise SystemExit(f"unknown options {only}")
    for i, (tag, cwd) in enumerate((("old", old), ("new", new), ("new", new), ("old", old))):
        out = subprocess.run([sys.executable, "-c", TIMER, str(CHIP_SMOKE), *only], cwd=cwd,
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
