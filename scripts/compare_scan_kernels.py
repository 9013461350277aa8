#!/usr/bin/env python3
"""Time K1 and K3 of two checkouts of the repository on one card, in turns.

    python3 scripts/compare_scan_kernels.py OLD_DIR NEW_DIR

Runs OLD, NEW, NEW, OLD, each in its own process from its directory (so
each builds and imports its own fwav_tpu_torch), on chip_smoke.py's seeded
inputs at the shapes it checks: K1 at 114,688 x 3,584 (balanced), 8,192 x
24,576 (damped, the exact branch) and 262,144 x 12,288 (balanced, a
shard); K3 (C = 4) at 114,688 x 3,584 (damped and balanced), 262,144 x
12,288 and 1,310,720 x 10,240 (damped). Both runs take their inputs and
their timer (chip_smoke.kernel_ms: the median over 20 samples of 10
back-to-back launches, by CUDA events) from this script's own checkout.
Prints one JSON line per run and the card's name and power limit.
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
for name, seed, M, D, obj in (("k1_coarse", 0, 114688, 3584, "balanced"),
                              ("k1_exact_damped", 1, 8192, 24576, "damped"),
                              ("k1_shard_balanced", 6, 262144, 12288, "balanced")):
    a = kernel_inputs(dev, seed, M, D, obj)
    args, kw = (a, {"s_clip": 16.0}) if obj == "damped" else (a[:4], {})
    res[name] = kernel_ms(lambda: kernels.search_scan(*args, **kw))
for name, seed, M, D, obj in (("k3_damped", 3, 114688, 3584, "damped"),
                              ("k3_balanced", 3, 114688, 3584, "balanced"),
                              ("k3_shard_damped", 7, 262144, 12288, "damped"),
                              ("k3_global_damped", 4, 1310720, 10240, "damped")):
    a = kernel_inputs(dev, seed, M, D, obj)
    res[name] = kernel_ms(lambda: kernels.topc_scan(*a[:4], 4, a[4], 16.0))
print(json.dumps(res))
"""


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    for i, (tag, cwd) in enumerate((("old", old), ("new", new), ("new", new), ("old", old))):
        out = subprocess.run([sys.executable, "-c", TIMER, str(CHIP_SMOKE)], cwd=cwd, capture_output=True,
                             text=True, timeout=900)
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
