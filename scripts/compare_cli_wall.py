#!/usr/bin/env python3
"""Time the CLI's one-shot and batch compress of two checkouts on one card.

    python3 scripts/compare_cli_wall.py OLD_DIR NEW_DIR [--rounds 1] [--files 48]
        [--seed 0] [--longest 60] [--device cuda]

Builds both checkouts' kernels at once, writes the inputs once (16-bit
44.1 kHz mono WAVs of bench.make_signal), then runs OLD, NEW, NEW, OLD
per round, each command in its own process from the checkout's directory (so each
imports its own fwav_tpu_torch), on the card:

- `single`: `compress one.wav out.fwav` of a 10 s file, what one
  `python -m fwav_tpu_torch compress in.wav out.fwav` pays;
- `mixed`: `compress DIR --batch --workers 4` over `--files` files of
  lengths drawn log-uniform from 1 to `--longest` s (seeded), one
  compress_audio_arrays per file, most lengths in a shape bucket of their
  own;
- `same`: the same batch command over 16 files of 9.9 to 10.1 s, which
  share one bucket.

Per run: the process's wall (host clock, from start to exit), the
`cli.main` call's wall inside it (the import, CUDA's start-up and the
kernel library's load left out), and where the checkout has one, its
program cache's counts (models/program.py PROGRAMS.stats: keys seen,
captures, replays, evictions, the pools' bytes). Every run must write the
same .fwav bytes as the others. Prints one JSON line per run, a summary
(per workload and checkout the median and quartiles of the `cli.main`
walls, and in how many of the rounds' pairs NEW was faster), and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import make_signal  # noqa: E402

BUILD = "from fwav_tpu_torch.ops import _build; _build.build(); _build.load()"

CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, ".")
import torch
from fwav_tpu_torch import cli
t1 = time.perf_counter()
rc = cli.main(sys.argv[1:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
t2 = time.perf_counter()
try:
    from fwav_tpu_torch.models.program import PROGRAMS
except ImportError:
    programs = None
else:
    st = PROGRAMS.stats(memory=torch.cuda.is_available())
    programs = {k: st[k] for k in ("capacity", "entries", "first_calls", "captures",
                                   "replays", "evictions")}
    programs["pool_bytes"] = [p.get("pool_bytes") for p in st["programs"]]
    programs["capture_s"] = [p["capture_s"] for p in st["programs"]]
print("RESULT " + json.dumps({"rc": rc, "import_s": t1 - t0, "main_s": t2 - t1,
                              "programs": programs}))
"""


def write_wav(path: Path, sig: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(sig.clip(-32768, 32767).astype(np.int16).tobytes())


def mixed_lengths(files: int, seed: int, longest: float) -> list:
    """Seconds of the mixed batch: log-uniform over 1..longest s."""
    rng = np.random.default_rng(seed)
    return [float(s) for s in np.exp(rng.uniform(0.0, np.log(longest), files))]


def digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def run(cwd: Path, argv) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CHILD, *map(str, argv)], cwd=cwd,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or not line:
        raise RuntimeError(f"{argv} in {cwd}: exit {out.returncode}\n{out.stderr[-3000:]}")
    res = json.loads(line[-1][len("RESULT "):])
    if res["rc"] != 0:
        raise RuntimeError(f"{argv} in {cwd}: cli exit code {res['rc']}")
    return {"process_s": wall, **res}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--files", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--longest", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = ap.parse_args()
    old, new = Path(args.old).resolve(), Path(args.new).resolve()
    if args.device != "cpu":
        builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d) for d in (old, new)]
        if any(p.wait(timeout=900) != 0 for p in builds):
            return 1
    dev = ["--device", args.device]
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        one = d / "one.wav"
        write_wav(one, make_signal(10.0))
        batches = {"mixed": mixed_lengths(args.files, args.seed, args.longest),
                   "same": [float(s) for s in np.linspace(9.9, 10.1, 16)]}
        for name, secs in batches.items():
            (d / name).mkdir()
            for i, s in enumerate(secs):
                write_wav(d / name / f"f{i:03d}.wav", make_signal(s))
        results, digests = {}, {}
        order = [("old", old), ("new", new), ("new", new), ("old", old)] * args.rounds
        for i, (tag, cwd) in enumerate(order):
            (d / f"single_{i}").mkdir()
            out_one = d / f"single_{i}" / "one.fwav"
            line = {"run": i, "checkout": tag,
                    "single": run(cwd, ["compress", one, out_one, *dev])}
            digests.setdefault("single", set()).add(digest([out_one]))
            for name in batches:
                out = d / f"{name}_{i}"
                line[name] = run(cwd, ["compress", d / name, "--batch", "--out", out,
                                       "--workers", "4", *dev])
                digests.setdefault(name, set()).add(digest(out.glob("*.fwav")))
            for k in ("single", *batches):
                results.setdefault((tag, k), []).append(line[k])
            print(json.dumps(line), flush=True)
    same_bytes = {k: len(v) == 1 for k, v in digests.items()}
    summary = {"files": {"mixed": len(batches["mixed"]), "same": len(batches["same"])},
               "mixed_seconds": batches["mixed"], "same_bytes": same_bytes}
    for (tag, k), runs in sorted(results.items()):
        walls = [r["main_s"] for r in runs]
        q = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls * 3
        summary[f"{k}_{tag}"] = {
            "main_s_median": statistics.median(walls), "main_s_quartiles": [q[0], q[2]],
            "process_s_median": statistics.median(r["process_s"] for r in runs),
            "main_s": walls}
    for k in ("single", *batches):  # the runs in order pair up old/new
        pairs = list(zip(results[("old", k)], results[("new", k)]))
        faster = sum(n["main_s"] < o["main_s"] for o, n in pairs)
        summary[f"{k}_new_faster_pairs"] = [faster, len(pairs)]
    print(json.dumps(summary))
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip().splitlines()[0])
    return 0 if all(same_bytes.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
