#!/usr/bin/env python3
"""Count the pairs that the wide scans' screen marks for the exact confirm.

    python3 scripts/count_wide_marks.py [--encode-tile T]

On the card. Builds fwav_tpu_torch/csrc with -DFWAV_COUNT_MARKS, under the
package's git-ignored _build/marks/, where csrc/scan_wide.cuh's confirm
adds one to a device counter for every marked (range, domain) pair, binds
the port's wrappers to that build, and runs K1 and K3 once at every shape
of chip_smoke.WIDE_CHECKS, on the inputs of chip_smoke.wide_kernel_checks
(with `--encode-tile T`: the K1 and K3 calls of one 10 s encode at tile T,
balanced and damped, on that encode's inputs, chip_smoke.encode_scan_calls).
Prints one JSON line per shape (marked pairs, per range, per range and
staged tile of its file's domains), then the card's name and power limit.
The kernels of the default build carry no counter.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the sources that instantiate a wide kernel (each keeps its own counter)
STEMS = ("search_scan", "topc_wide_n64", "topc_wide_n128", "topc_wide_n255")


def stem_of(scan: str, N: int) -> str:
    """The source whose copy of the counter a launch adds to: K1's wide
    kernel is in search_scan.cu, K3's in one source per block-shape class
    (csrc/topc_wide.cuh)."""
    if scan == "search_scan":
        return "search_scan"
    return "topc_wide_n64" if N <= 64 else "topc_wide_n128" if N <= 128 else "topc_wide_n255"


def cases(chip_smoke, dev, argv):
    """(key, scan, args, kwargs) of every launch to count: the shapes of
    chip_smoke.WIDE_CHECKS, or with `--encode-tile T` the K1 and K3 calls
    of one 10 s encode at tile T, balanced and damped."""
    if argv[:1] == ["--encode-tile"]:
        tile = int(argv[1])
        for obj in ("balanced", "damped"):
            for i, (scan, args, kw) in enumerate(chip_smoke.encode_scan_calls(tile, obj)):
                yield f"enc{tile}_{obj}_{scan}{i}", scan, args, kw
        return
    for key, scan, N, M, D, objective in chip_smoke.WIDE_CHECKS:
        a = chip_smoke.kernel_inputs(dev, 500 + N, M, D, objective, N=N)
        if scan == "search_scan":
            yield key, scan, a if objective == "damped" else a[:4], (
                {"s_clip": 16.0} if objective == "damped" else {})
        else:
            yield key, scan, (*a[:4], 4, a[4], 16.0), {}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("count_wide_marks: no CUDA device", file=sys.stderr)
        return 2
    from fwav_tpu_torch.ops import _build, kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DFWAV_COUNT_MARKS"]
    _build.BUILD_DIR = _build.BUILD_DIR / "marks"
    _build._lib = None
    lib = _build.load()
    for stem in STEMS:
        getattr(lib, f"fwav_wide_marks_{stem}").restype = ctypes.c_ulonglong
    dev = torch.device("cuda")
    for key, scan, args, kw in cases(chip_smoke, dev, sys.argv[1:]):
        r_c, bank_t, valid = args[0], args[1], args[3]
        N, M, D = r_c.shape[-1], r_c.shape[-2], bank_t.shape[-1]
        reader = getattr(lib, f"fwav_wide_marks_{stem_of(scan, N)}")
        reader()
        getattr(kernels, scan)(*args, **kw)
        torch.cuda.synchronize()
        marks = int(reader())
        tile = 128 if N <= 64 else 64 if N <= 128 else 32  # csrc/scan_wide.cuh WideShape
        print(json.dumps({"check": key, "N": N, "ranges": M, "domains": D,
                          "valid": int(valid.sum()), "marked": marks,
                          "per_range": marks / M,
                          "per_range_and_tile": marks / M / -(-D // tile)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
