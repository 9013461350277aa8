"""The control of the check: the reference, in bfloat16, in the codec's place.

For each seed it builds the cell's pool, takes the files a run would
check (the same seeded sample, the longest file among them), encodes each
with the reference in float32 and with the same reference on bfloat16
inputs (reference/encode.py lowp), and judges the second against the
first as a run judges the codec. A limit must lie below the smallest of
these readings. Runs on the card at the cell's own size:

    python3 benchmarks/control.py --workload default.speech10s --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmarks import harness, pool  # noqa: E402
from benchmarks.reference import compare  # noqa: E402
from benchmarks.reference import encode as ref_encode  # noqa: E402


def readings(name: str, seed: int, device: str = "cuda", mix: dict | None = None) -> dict:
    """The control's worst number of each kind over one seed's checked files."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    config = harness.find_config(bench, cell["config"])
    mix = mix or harness.find_mix(cell["traffic"])
    cfg = ref_encode.Settings(**config["encoder"])
    files = pool.build(mix, config["sample_rate"], seed)
    everyone = [f.index for f in files]
    longest = max(everyone, key=lambda i: len(files[i].samples))
    worst = {n: 0 for n in compare.NAMES}
    entry = harness.find_entry(config["entry"])
    for i in pool.sample(everyone, longest, mix["check_files"], seed):
        ref = entry.reference(cfg, files[i].samples, device)
        low = entry.reference(cfg, files[i].samples, device, lowp=True)
        nums = compare.judge(ref, compare.from_reference(low, cfg), cfg)
        for n, v in nums.items():
            worst[n] = max(worst[n], v)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
