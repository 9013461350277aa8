"""The cost of the phase tracing (fwav_tpu_torch/utils/trace.py) on the card.

The median host-clock time of N calls, three ways: without a collector,
inside `collect_phases`, and under `torch_profile` (the profiler's start,
stop and export lie outside the timed call). Two requests are timed: the
10 s default encode (`compress_audio_arrays`) and the 10 s compact file
(`process_file_compress(..., compact=True, objective="damped")` on a
16-bit WAV). The three ways take turns within each round, after three
warm-up calls of each request (a shape key runs eagerly, then is
captured, then replays). Beside them, the mean cost of one empty phase
the same three ways, over SPANS spans.

    python3 scripts/measure_trace_cost.py [--root CHECKOUT] [--calls 12]

--root imports the package of another checkout (a parent unpacked with
`git archive`), so that two versions are timed in one call on one card.
Prints one JSON line. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
#: Empty phases timed for the cost of one span.
SPANS = 20000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose package is timed")
    ap.add_argument("--calls", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("measure_trace_cost: no CUDA device", file=sys.stderr)
        return 2
    import fwav_tpu_torch as port
    from bench import make_signal
    from fwav_tpu_torch.io.wav import write_wav
    from fwav_tpu_torch.models.codec import process_file_compress
    from fwav_tpu_torch.utils.trace import collect_phases, phase, torch_profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    sig = make_signal(10.0)
    out = {"root": args.root, "package": os.path.dirname(port.__file__), "card": smi,
           "torch": torch.__version__, "calls": args.calls,
           "profiler_flag": hasattr(torch.autograd.profiler, "_is_profiler_enabled")}

    def spans_us():
        t0 = time.perf_counter()
        for _ in range(SPANS):
            with phase("empty"):
                pass
        return (time.perf_counter() - t0) / SPANS * 1e6

    off = spans_us()
    with collect_phases():
        collector = spans_us()
    with torch.profiler.profile():
        profiler = spans_us()
    out["span_us"] = {"off": off, "collector": collector, "profiler": profiler}
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "speech10s.wav")
        write_wav(wav, sig, 44100, 2)

        def compact():
            res = process_file_compress(wav, os.path.join(tmp, "out"), compact=True,
                                        objective="damped", device="cuda")
            if "error" in res:
                raise RuntimeError(res["error"])

        requests = {
            "default_encode": lambda: port.compress_audio_arrays(sig, 44100, 2, device="cuda"),
            "compact_file": compact,
        }
        for name, call in requests.items():
            for _ in range(3):
                call()
            times = {"off": [], "collector": [], "profiler": []}
            phases = []
            for k in range(args.calls):
                t0 = time.perf_counter()
                call()
                times["off"].append(time.perf_counter() - t0)
                with collect_phases() as ph:
                    t0 = time.perf_counter()
                    call()
                    times["collector"].append(time.perf_counter() - t0)
                phases.append(ph)
                with torch_profile(os.path.join(tmp, f"trace_{name}_{k}")):
                    t0 = time.perf_counter()
                    call()
                    times["profiler"].append(time.perf_counter() - t0)
            out[name] = {
                "median_ms": {w: statistics.median(v) * 1e3 for w, v in times.items()},
                "ms": {w: [t * 1e3 for t in v] for w, v in times.items()},
                "phases_ms_median": {p: statistics.median(t.get(p, 0.0) for t in phases) * 1e3
                                     for p in sorted(set().union(*phases))},
            }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
