"""The harness is driven by data: a new configuration, kind of request
(entry), traffic mix, limits, metric reader and kernel count are found by
name, with no edit to a file that is there. The benchmark folder is copied with new files added
and driven in a fresh process."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    dst = tmp_path / "benchmarks"
    shutil.copytree(ROOT / "benchmarks", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((dst / "configs" / "fwav_default.json").read_text())
    cfg.update(name="fwav_tile512", encoder={**cfg["encoder"], "tile_size": 512},
               entry="arrays_counted")
    (dst / "configs" / "fwav_tile512.json").write_text(json.dumps(cfg))
    mix = json.loads((dst / "traffic" / "speech10s.json").read_text())
    mix.update(name="tiny", pool_files=2, seconds=[1.5, 2.0], check_files=2)
    (dst / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (dst / "limits" / "tile512.tiny.json").write_text(
        (dst / "limits" / "default.speech10s.json").read_text())
    # a new kind of request: the library call on a copy of the samples,
    # with a reference and kernel calls of its own that leave a mark
    (dst / "entries" / "arrays_counted.py").write_text(
        "from ..reference import encode\n"
        "from .arrays import Entry as Arrays\n"
        "MARKS = []\n\n"
        "class Entry(Arrays):\n"
        "    def request(self, i):\n"
        "        self.latest[i] = self._encode(self.files[i].samples.copy(), self.sr, self.sw,\n"
        "                                      **self.kw)\n\n"
        "    @staticmethod\n"
        "    def reference(cfg, samples, device, lowp=False):\n"
        "        MARKS.append('reference')\n"
        "        return encode.encode(samples, cfg, device, lowp)\n")
    (dst / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.timed))\n")
    (dst / "roofline" / "k9.py").write_text(
        "SYMBOLS = ('k9_kernel',)\n\ndef work(call):\n    return 1, 1\n")
    bench["configs"].append({"name": "fwav_tile512", "source": "x",
                             "file": "benchmarks/configs/fwav_tile512.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "tile512.tiny", "config": "fwav_tile512",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        "from benchmarks import harness\n"
        "assert harness.ROOT == __import__('pathlib').Path.cwd()\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "out = harness.run_cell(bench, 'tile512.tiny', 5, 1.0, False, device='cpu')\n"
        "run = harness.Run([], None, None, [])\n"
        "from benchmarks.entries import arrays_counted\n"
        "print(json.dumps({'correct': out['correct'], 'metric': harness.find_metric("
        "'requests_done')(run), 'k9': harness.find_roofline('k9').SYMBOLS,"
        " 'entry': harness.find_entry('arrays_counted') is arrays_counted.Entry,"
        " 'references': len(arrays_counted.MARKS), 'checked': len(out['_checked'])}))\n"
    )
    env_path = f"{tmp_path}:{ROOT}"
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                                          "HOME": str(tmp_path)}, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "metric": 0.0, "k9": ["k9_kernel"], "entry": True,
                   "references": 2, "checked": 2}
