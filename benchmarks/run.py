"""Run one cell of the benchmark once; see benchmarks/harness.py.

    python3 benchmarks/run.py --workload default.speech10s --seed 7 --seconds 30 --trace 0
"""

import sys
from pathlib import Path

# the checkout's root, not this directory, heads the import path: the
# benchmark is the package `benchmarks`, the codec the package beside it
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmarks.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
