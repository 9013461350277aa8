"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level module names (the port's name begins with the
JAX package's), and the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _run(
        "import json\n"
        "from benchmarks import harness\n"
        "mix = harness.find_mix('speech10s')\n"
        "mix.update(pool_files=2, seconds=[1.5, 2.0], check_files=1)\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "out = harness.run_cell(bench, 'compact.speech10s', 3, 0.5, False, device='cpu', "
        "mix=mix)\n"
        "import sys\n"
        "print(json.dumps({'banned': harness.banned_modules(), 'error': out.get('error'),"
        " 'port': 'fwav_tpu_torch' in sys.modules}))\n")
    assert got == {"banned": [], "error": None, "port": True}


def test_banned_names_are_whole_top_level_names():
    from benchmarks import harness

    assert "fwav_tpu" in harness.BANNED
    before = dict(sys.modules)
    try:
        sys.modules["fwav_tpu_torch_extra"] = object()
        sys.modules["jaxlike.sub"] = object()
        assert "fwav_tpu" not in harness.banned_modules() or "fwav_tpu" in before
        sys.modules["jax.numpy"] = object()
        assert "jax" in harness.banned_modules()
    finally:
        for k in ("fwav_tpu_torch_extra", "jaxlike.sub", "jax.numpy"):
            if k not in before:
                sys.modules.pop(k, None)


def test_reference_loads_nothing_of_the_program():
    got = _run(
        "import json, sys\n"
        "import benchmarks.reference.encode, benchmarks.reference.compare, "
        "benchmarks.reference.v2, benchmarks.pool, benchmarks.calls\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'fwav_tpu_torch', 'fwav_tpu', 'jax', 'jaxlib', 'flax'})))\n")
    assert got == []
