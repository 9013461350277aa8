#!/usr/bin/env python3
"""Time K4 (the staged window refine) of two checkouts on one card, in turns.

    python3 scripts/compare_staged_kernel.py OLD_DIR NEW_DIR

Runs OLD, NEW, NEW, OLD, each in its own process from its directory (so
each builds and imports its own fwav_tpu_torch), on chip_smoke.py's K4
inputs at the shapes it checks (chip_smoke.k4_shapes: the 100 s global
pass, the eight staged single-shot shapes of chip_smoke.K4_CHECKS and the
tile-512 damped stack of 16). Each checkout's K4 call is timed whole
(`k4_*`: with a per-row table where it makes one, the table and the
scoring launch, as the encoders call it). A checkout with the table
(kernels.staged_stats) is also timed scoring on a table made before
(`score_*`, chip_smoke.k4_score, at every shape: at a descent of up to 16
taps too, where the wrapper makes no table) and for the table alone
(`stats_*`), and the scoring's results are held bit for bit to the whole
call's. Each run first reports the peak memory of a first 60 s damped
encode and of three 100 s damped streams (chip_smoke.stream_run), as
chip_smoke.py's staged and stream phases measure them. Inputs and timer
(chip_smoke.graph_ms: 10
back-to-back calls captured in a CUDA graph, the median of 20 replays by
CUDA events, so that the host's launch time is not counted) come from this
script's own checkout. Prints one JSON line per run, then the card's name
and power limit.
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
from bench import make_signal
import fwav_tpu_torch as port
from fwav_tpu_torch.models import encode as enc
from fwav_tpu_torch.ops import kernels

dev = torch.device("cuda")
table = hasattr(kernels, "staged_stats")
res = {}
stream_sig = make_signal(chip_smoke.STREAM_SECONDS)
# peak memory first, in a process that has allocated nothing yet
torch.cuda.reset_peak_memory_stats()
port.compress_audio_arrays(make_signal(60.0), 44100, 2, device="cuda", objective="damped")
res["peak_mb_60s_damped"] = torch.cuda.max_memory_allocated() / 2**20
torch.cuda.reset_peak_memory_stats()
chip_smoke.stream_run(port, kernels, stream_sig, 3, objective="damped")
res["peak_mb_100s_stream_damped"] = torch.cuda.max_memory_allocated() / 2**20
for key, args, stride, cfg, per_lobe in chip_smoke.k4_shapes(port, kernels, enc, dev,
                                                             stream_sig):
    k4 = (*args, stride, cfg.objective, cfg.s_clip, per_lobe)
    name = key[3:]
    res["k4_" + name] = chip_smoke.graph_ms(lambda: kernels.staged_refine(*k4))
    if table:
        want = kernels.staged_refine(*k4)
        made = (args[1], cfg.objective, cfg.s_clip)
        stats = kernels.staged_stats(*made)
        got = chip_smoke.k4_score(kernels, *k4, stats)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))):
            raise AssertionError(f"{key}: the scoring on a table made before differs")
        res["score_" + name] = chip_smoke.graph_ms(lambda: chip_smoke.k4_score(kernels, *k4,
                                                                               stats))
        res["stats_" + name] = chip_smoke.graph_ms(lambda: kernels.staged_stats(*made))
        del stats, want, got
    del args, k4
print(json.dumps(res))
"""


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    runs = [("old", old), ("new", new), ("new", new), ("old", old)]
    for i, (tag, cwd) in enumerate(runs):
        out = subprocess.run(
            [sys.executable, "-c", TIMER, str(CHIP_SMOKE)],
            cwd=cwd, capture_output=True, text=True, timeout=1200)
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
