#!/usr/bin/env python3
"""Count the rows where K1 and K3 differ from their plain versions on
ranges of tiny scale.

    python3 scripts/probe_tiny_ranges.py

On the card. For range sizes 4, 8, 16 (csrc/scan_tile.cuh) and 17, 64,
255 (csrc/scan_wide.cuh), balanced and damped, three seeds each: the
inputs of chip_smoke.kernel_inputs (600 ranges x 3,000 domains), each
range scaled by one factor drawn from 1e-23..1e-21, so that num^2 w falls
into float32's subnormals or to 0 and many scores tie. Runs K1 and K3 (C
1, 4 and 8) once and their plain versions, and prints one JSON line per
case: the rows whose K1 index or score differs and the rows whose K3 list
differs, for each C. Then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_tiny_ranges: no CUDA device", file=sys.stderr)
        return 2
    from fwav_tpu_torch.ops import kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    dev = torch.device("cuda")
    M, D = 600, 3000
    for objective in ("balanced", "damped"):
        for N in (4, 8, 16, 17, 64, 255):
            for seed in range(3):
                r_c, bank_t, w, valid, thresh = chip_smoke.kernel_inputs(
                    dev, 700 + 10 * N + seed, M, D, objective, N=N)
                scale = 10.0 ** np.random.default_rng(seed).uniform(-23, -21, (M, 1))
                r_c *= torch.from_numpy(scale.astype(np.float32)).to(dev)
                args = (r_c, bank_t, w, valid, thresh, 16.0)
                s_k, i_k = kernels.search_scan(*args)
                s_p, i_p = kernels.search_scan_ref(*args)
                k3 = {}
                for C in (1, 4, 8):
                    got = kernels.topc_scan(r_c, bank_t, w, valid, C, thresh, 16.0)
                    want = kernels.topc_scan_ref(r_c, bank_t, w, valid, C, thresh, 16.0)
                    k3[C] = int((got != want).any(1).sum())
                print(json.dumps({"objective": objective, "N": N, "seed": seed,
                                  "k1_rows_differ": int(((i_k != i_p) | (s_k != s_p)).sum()),
                                  "k3_rows_differ": k3}),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
