#!/usr/bin/env python3
"""Time the topk compatibility mode of two checkouts on one card, in turns.

    python3 scripts/compare_topk_encode.py OLD_DIR NEW_DIR

Runs OLD, NEW, NEW, OLD, each in its own process from its directory (so
each imports its own fwav_tpu_torch). Each run times, on the card:

- `stable_topk_ms`: `ops.search._stable_topk(score, 32)` on one seeded
  score block of the 10 s encode's shape (16,384 ranges x 2,048 domains,
  runs of exact ties planted), CUDA events around 20 calls, the median of 5;
- `block_ms`: `topk_scores_block` over one range block against the whole
  bank's embeddings (16,384 x 450,560, 220 domain blocks of 2,048),
  CUDA events, the median of 3;
- `encode_s`: `compress_audio_arrays(bench.make_signal(10.0), 44100, 2,
  search="topk", device="cuda")` after one warm call, host clock with the
  stream synchronized, the median of 3, and its sentinel count.

Prints one JSON line per run and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TIMER = r"""
import json, statistics, sys, time, numpy as np, torch
sys.path.insert(0, ".")
from bench import make_signal
from fwav_tpu_torch.models.encode import compress_audio_arrays
from fwav_tpu_torch.ops import search

dev = torch.device("cuda")


def events_ms(fn, calls, reps):
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


rng = np.random.default_rng(0)
score = torch.from_numpy((rng.integers(0, 64, (16384, 2048)) / 8.0).astype(np.float32)).to(dev)
score[::7, 1500:] = float("-inf")
res = {"stable_topk_ms": events_ms(lambda: search._stable_topk(score, 32), 20, 5)}

q = torch.from_numpy(rng.standard_normal((16384, 16)).astype(np.float32)).to(dev)
emb = torch.from_numpy(rng.standard_normal((450560, 16)).astype(np.float32)).to(dev)
valid = torch.arange(450560, device=dev) < 440000
res["block_ms"] = events_ms(lambda: search.topk_scores_block(q, emb, valid, 32, 2048), 1, 3)

sig = make_signal(10.0)
compress_audio_arrays(sig, 44100, 2, search="topk", device="cuda")
times = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = compress_audio_arrays(sig, 44100, 2, search="topk", device="cuda")
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
res["encode_s"] = statistics.median(times)
res["encode_s_all"] = times
res["sentinels"] = int((out[0]["idx"] < 0).sum())
print(json.dumps(res))
"""


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    for i, (tag, cwd) in enumerate((("old", old), ("new", new), ("new", new), ("old", old))):
        out = subprocess.run([sys.executable, "-c", TIMER], cwd=cwd,
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        times = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": tag, "dir": str(cwd), **times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
