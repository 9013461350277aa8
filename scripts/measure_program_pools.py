#!/usr/bin/env python3
"""Measure the captured encode programs' memory pools on the card.

    python3 scripts/measure_program_pools.py [--device cuda] [--cases NAME ...]

For each case (a single-shot encode or a packed stack of `bench.make_signal`
files, at a tile size and objective) calls the encoder three times on the
same input: the key's first call (eager), its second (the eager warm-up and
the capture) and its third (a replay). Prints one JSON line per case: the
plan (`_plan_search`), the walls of the three calls (host clock), the peak
device memory allocated during each, and the program's pool (models/program.py
`Program.pool`, read after the capture) with its graph's nodes; then one line
with every program the cache holds, the sum of their pools against
GRAPH_CACHE_BYTES and the device memory reserved; and the card's name and
power limit. The cache's own bound is lifted for the run, so that every case's
program stays. `--device cpu` is a dry run of the script at small sizes: no
program is captured there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import make_signal  # noqa: E402

#: name -> (seconds, files, EncoderConfig keywords)
CASES = {
    "10s_default": (10.0, 1, {}),
    "10s_tile512_damped": (10.0, 1, {"tile_size": 512, "objective": "damped"}),
    "60s_default": (60.0, 1, {}),
    "60s_damped": (60.0, 1, {"objective": "damped"}),
    "94s_default": (94.0, 1, {}),
    "94s_damped": (94.0, 1, {"objective": "damped"}),
    "16x10s_tile512_damped": (10.0, 16, {"tile_size": 512, "objective": "damped"}),
    "16x60s_damped": (60.0, 16, {"objective": "damped"}),
}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    args = ap.parse_args()

    import torch

    from fwav_tpu_torch.config import EncoderConfig
    from fwav_tpu_torch.models import encode as enc
    from fwav_tpu_torch.models.program import GRAPH_CACHE_BYTES, PROGRAMS

    cuda = args.device != "cpu"
    PROGRAMS.clear()
    PROGRAMS.capacity, PROGRAMS.max_bytes = len(CASES) + 1, 1 << 62
    for name in args.cases:
        seconds, files, kw = CASES[name]
        if not cuda:
            seconds = min(seconds, 1.0)
        sig = make_signal(seconds)
        cfg = EncoderConfig(**kw)
        _, _, _, lb, db = enc._prep_signal(sig, cfg)
        plan = enc._plan_search(cfg, lb // cfg.range_size, db)
        before = set(PROGRAMS.keys())
        walls, peaks = [], []
        outs = []
        for _ in range(3):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if files == 1:
                outs.append(enc.compress_audio_arrays(sig, 44100, 2, config=cfg,
                                                      device=args.device)[0])
            else:
                outs.append([r[0] for r in enc.compress_audio_packed(
                    [sig] * files, 44100, 2, config=cfg, device=args.device)])
            if cuda:
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated())
            walls.append(time.perf_counter() - t0)
        per_file = [o if files > 1 else [o] for o in outs]
        equal = all(np.array_equal(a, b) for o in per_file[1:] for a, b in zip(per_file[0], o))
        if not equal:
            raise AssertionError(f"{name}: a replay's records differ from the eager run's")
        new = [k for k in PROGRAMS.keys() if k not in before]
        progs = {p["key"]: p for p in PROGRAMS.stats(memory=True)["programs"]}
        prog = progs[new[0]] if new else None
        print(json.dumps({
            "case": name, "seconds": seconds, "files": files, "config": kw,
            "plan": list(plan), "walls_s": walls, "peak_allocated_bytes": peaks,
            "pool_bytes": prog and prog["pool_bytes"], "nodes": prog and prog["nodes"],
            "replays": prog and prog["replays"], "records_equal": equal}), flush=True)
    st = PROGRAMS.stats(memory=True)
    pools = [p["pool_bytes"] for p in st["programs"]]
    print(json.dumps({
        "programs": len(pools), "pool_bytes": pools,
        "pool_bytes_sum": sum(p or 0 for p in pools), "graph_cache_bytes": GRAPH_CACHE_BYTES,
        "reserved_bytes": torch.cuda.memory_reserved() if cuda else None}), flush=True)
    print(card())
    PROGRAMS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
