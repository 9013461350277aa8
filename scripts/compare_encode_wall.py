#!/usr/bin/env python3
"""Time the 10 s encode of two checkouts on one card, in turns.

    python3 scripts/compare_encode_wall.py OLD_DIR NEW_DIR [--rounds 2] [--tile 1024]

Builds both checkouts' kernels at once, then runs OLD, NEW, NEW, OLD (per
round), each in its own process from its directory (so each imports its
own fwav_tpu_torch). Each run times `compress_audio_arrays(
bench.make_signal(10.0), 44100, 2, tile_size=TILE, device="cuda")`,
default and damped, after two warm calls: host clock over 12 calls (the
records reach the host, so each call ends synchronized), their min, median
and max, and the sentinel count. Prints one JSON line per run, the median
of each checkout's medians per objective, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BUILD = "from fwav_tpu_torch.ops import _build; _build.build(); _build.load()"

TIMER = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
from bench import make_signal
from fwav_tpu_torch.models.encode import compress_audio_arrays

sig = make_signal(10.0)
res = {}
for name, kw in (("default", {}), ("damped", {"objective": "damped"})):
    kw["tile_size"] = int(sys.argv[1])
    for _ in range(2):
        compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        out = compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        times.append((time.perf_counter() - t0) * 1e3)
    res[name] = {"min_ms": min(times), "median_ms": statistics.median(times),
                 "max_ms": max(times), "sentinels": int((out[0]["idx"] < 0).sum())}
print(json.dumps(res))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tile", type=int, default=1024)
    args = ap.parse_args()
    old, new = Path(args.old).resolve(), Path(args.new).resolve()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d) for d in (old, new)]
    if any(p.wait(timeout=900) != 0 for p in builds):
        return 1
    medians = {obj: {"old": [], "new": []} for obj in ("default", "damped")}
    for r in range(args.rounds):
        for tag, cwd in (("old", old), ("new", new), ("new", new), ("old", old)):
            out = subprocess.run([sys.executable, "-c", TIMER, str(args.tile)], cwd=cwd,
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                print(out.stdout, out.stderr, file=sys.stderr)
                return out.returncode
            times = json.loads(out.stdout.strip().splitlines()[-1])
            for obj in medians:
                medians[obj][tag].append(times[obj]["median_ms"])
            print(json.dumps({"round": r, "checkout": tag, "tile": args.tile,
                              "dir": str(cwd), **times}), flush=True)
    print(json.dumps({f"{obj}_median_of_medians_ms": {k: statistics.median(v)
                                                      for k, v in m.items()}
                      for obj, m in medians.items()}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
