"""One run of one cell of the benchmark: set-up, the measured window, the
check against the reference, one JSON line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's configuration
(`configs/<name>.json`), what a request is by the configuration's "entry"
(`entries/<entry>.py`: the call, its answer, its reference and its kernel
calls), its traffic mix (`traffic/<name>.json`, read by pool.py), its
limits (`limits/<cell>.json`), each per-layer metric's reader
(`metrics/<name>.py`) and each kernel's work count (`roofline/<kernel>.py`).

The client is one closed loop: a request is sent as soon as the previous
one returned, from a seeded order over a pool of files made in set-up.
Set-up sends every pool file until the codec's program counters show that
it neither ran a new shape key nor captured one, so nothing compiles or is
captured inside the window. With --trace 0 the
line carries the cell's end-to-end metrics; with --trace 1 its per-layer
metrics, read from the phases of every request and from a torch.profiler
trace of the window's last seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from . import devtrace, pool
from .reference import compare
from .reference import encode as ref_encode

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names the run may not hold once the window has closed.
BANNED = ("jax", "jaxlib", "flax", "fwav_tpu")
#: Seconds of the window that --trace 1 profiles (its last ones).
TRACE_SECONDS = 5.0
#: Phases of a request that no other phase encloses: the rest of its
#: wall time is what no phase covers.
TOP_PHASES = ("device", "vad", "refit", "dispatch", "fetch_wait", "host_refit", "global_pass")
#: Requests of one pool file in the warm-up before its shape is taken to
#: never settle (the codec runs a key eagerly, then captures it).
WARM_MAX = 4


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_config(bench: dict, name: str) -> dict:
    """The configuration file BENCHMARK.json names for `name`."""
    return load_json(ROOT / {c["name"]: c for c in bench["configs"]}[name]["file"])


def find_mix(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def find_limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def find_metric(name: str):
    """The reader of a per-layer metric: metrics/<name>.py's `read`."""
    return importlib.import_module(f"{__package__}.metrics.{name}").read


def find_entry(name: str):
    """What a request is: entries/<name>.py's `Entry`."""
    return importlib.import_module(f"{__package__}.entries.{name}").Entry


def find_roofline(kernel: str):
    """A kernel's work count: roofline/<kernel>.py."""
    return importlib.import_module(f"{__package__}.roofline.{kernel}")


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class Request:
    file: int         # pool index
    t0: float         # perf_counter at send and at return
    t1: float
    phases: dict      # the program's phase seconds inside the request
    ok: bool
    traced: bool      # inside the profiled block

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def unphased_s(self) -> float:
        return self.wall_s - sum(self.phases.get(k, 0.0) for k in TOP_PHASES)


class Run:
    """What the per-layer readers read: the window's requests (`timed`:
    those outside the profiled seconds), the traced block's Window, the
    cell's settings and files."""

    def __init__(self, requests, window, settings, files, entry=None):
        self.requests = requests
        self.window = window
        self.settings = settings
        self.files = files
        self.entry = entry
        self.timed = [r for r in requests if r.ok and not r.traced] or [
            r for r in requests if r.ok]

    def phase_ms(self, fn) -> float | None:
        """Mean over the timed requests of fn(phases) seconds, in ms; None
        where no request recorded the phases fn reads."""
        vals = [fn(r.phases) for r in self.timed]
        vals = [v for v in vals if v is not None]
        return 1000.0 * float(np.mean(vals)) if vals else None

    def roofline(self, kernel: str) -> float | None:
        """The kernel's share of its roofline over the traced requests, in
        %: the least time their calls need (roofline/<kernel>.py) over the
        time the trace shows for its symbols. None where the trace holds no
        call of it."""
        if self.window is None:
            return None
        mod = find_roofline(kernel)
        peaks = load_json(HERE / "roofline" / "peaks.json")
        need = 0.0
        for r in self.requests:
            if not (r.traced and r.ok):
                continue
            n = len(self.files[r.file].samples)
            for call in self.entry.kernel_calls(self.settings, n):
                if call["kernel"] == kernel:
                    flops, nbytes = mod.work(call)
                    need += max(flops / peaks["bf16_tensor_flops_per_s"],
                                nbytes / peaks["hbm_bytes_per_s"])
        seconds = self.window.kernel_seconds(mod.SYMBOLS)
        if need == 0.0 or seconds == 0.0:
            return None
        return 100.0 * need / seconds


def parse_args(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Device:
    """The card the run measures, or the CPU of a rehearsal (tests)."""

    def __init__(self, kind: str):
        import torch

        self.torch = torch
        self.kind = kind
        self.cuda = kind == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def name(self) -> str:
        return self.torch.cuda.get_device_name(0) if self.cuda else "cpu"

    def free(self) -> None:
        if self.cuda:
            self.torch.cuda.empty_cache()


def program_counts() -> tuple:
    """The codec's program cache counters: keys run once eagerly, keys
    captured."""
    from fwav_tpu_torch.models.program import PROGRAMS

    st = PROGRAMS.stats()
    return st["first_calls"], st["captures"]


def warm_up(entry, files) -> dict:
    """Sends every pool file until one of its requests leaves the codec's
    counters unchanged: it ran no shape key for the first time and
    captured none. Nothing of the codec's buckets is assumed. Returns each
    file's shape key: the codec's most recently used program after that
    request (None where it keeps none)."""
    from fwav_tpu_torch.models.program import PROGRAMS

    keys = {}
    for f in files:
        for _ in range(WARM_MAX):
            before = program_counts()
            entry.request(f.index)
            if program_counts() == before:
                break
        else:
            raise RuntimeError(f"pool file {f.index} ran a new shape in each of "
                               f"{WARM_MAX} requests")
        used = PROGRAMS.keys()
        keys[f.index] = used[-1] if used else None
    return keys


def run_window(entry, files, seconds: float, seed: int, trace: bool, dev: Device):
    """The closed loop: requests back to back until `seconds` have passed.
    With --trace 1 the window ends under the profiler: its last
    TRACE_SECONDS, and on until every pool file has been sent in the
    traced block. Returns (requests, window seconds, the traced block or
    None)."""
    import torch
    from fwav_tpu_torch.utils.trace import collect_phases

    order = pool.order(len(files), seed)
    requests = []
    traced = None

    def loop(until: float, in_trace: bool, cover: bool = False):
        seen = set()
        while time.perf_counter() < until or (cover and len(seen) < len(files)):
            i = next(order)
            seen.add(i)
            ok = True
            t0 = time.perf_counter()
            with collect_phases() as ph, torch.profiler.record_function("bench.request"):
                try:
                    entry.request(i)
                except Exception:  # noqa: BLE001 — a failed request is counted, not fatal
                    ok = False
                    traceback.print_exc(file=sys.stderr)
            requests.append(Request(i, t0, time.perf_counter(), dict(ph), ok, in_trace))

    start = time.perf_counter()
    tail = min(TRACE_SECONDS, seconds) if trace else 0.0
    loop(start + seconds - tail, False)
    if trace:
        with devtrace.padded() as traced:
            loop(time.perf_counter() + tail, True, cover=True)
    dev.sync()
    end = requests[-1].t1 if requests else time.perf_counter()
    return requests, end - start, traced


def check(entry, files, requests, cfg, config, limits, seed, k, keys, dev: Device):
    """The numbers of the sampled answers (one file of each shape key, the
    longest, more drawn from the seed up to k), each the worst over them,
    and whether every one is within its limit."""
    done = [r.file for r in requests if r.ok]
    longest = max(done, key=lambda i: len(files[i].samples)) if done else -1
    picked = pool.sample(done, longest, k, seed, keys)
    hint = (config.get("container") or {}).get("decode_hint")
    worst = {n: 0 for n in compare.NAMES}
    for i in picked:
        ref = entry.reference(cfg, files[i].samples, dev.kind)
        try:
            nums = compare.judge(ref, entry.answer(i), cfg, hint)
        except Exception:  # noqa: BLE001 — an answer that cannot be read is wrong
            traceback.print_exc(file=sys.stderr)
            nums = dict.fromkeys(compare.NAMES, compare.UNJUDGED)
        for n, v in nums.items():
            worst[n] = max(worst[n], v)
        del ref
        dev.free()
    ok = bool(picked) and all(worst[n] <= limits[n] for n in compare.NAMES)
    return ok, {n: {"value": worst[n], "limit": limits[n]} for n in compare.NAMES}, picked


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", mix: dict | None = None, entry_cls=None) -> dict:
    """One run of cell `name`: the result's dict (the JSON line), or an
    "error" key where the run may print no result. `device`, `mix` and
    `entry_cls` (in place of the configuration's entry) are for rehearsals
    on the CPU."""
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    config = find_config(bench, cell["config"])
    mix = mix or find_mix(cell["traffic"])
    limits = find_limits(name)
    cfg = ref_encode.Settings(**config["encoder"])
    dev = Device(device)

    files = pool.build(mix, config["sample_rate"], seed)
    with tempfile.TemporaryDirectory(prefix="fwav-bench-") as workdir:
        entry = (entry_cls or find_entry(config["entry"]))(config, files, workdir, device)
        from fwav_tpu_torch.models.program import PROGRAMS

        keys = warm_up(entry, files)
        dev.sync()
        setup_s = process_age()
        counts = program_counts()
        requests, window_s, traced = run_window(entry, files, seconds, seed, trace, dev)
        peak = dev.peak_bytes()
        found = banned_modules()
        if found:
            return {"error": f"the run holds {found} once the window has closed"}
        if program_counts() != counts:
            return {"error": "a shape key ran for the first time or was captured inside the "
                             "window"}
        window = devtrace.read(traced) if traced else None
        PROGRAMS.clear()
        dev.free()
        ok, checks, picked = check(entry, files, requests, cfg, config, limits, seed,
                                   mix["check_files"], keys, dev)

    failed = sum(not r.ok for r in requests)
    device_info = {"platform": "gpu" if dev.cuda else "cpu", "kind": dev.name(),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": ok and failed == 0, "attempted": len(requests), "failed": failed}
    if trace:
        run = Run(requests, window, cfg, files, entry)
        metrics = {}
        for m in bench["per_layer"]:
            if name in m.get("workloads", [name]):
                v = find_metric(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=window.busy_s, window_s=window.window_s)
        out.update(metrics=metrics, device=device_info,
                   breakdown={"device_ops": devtrace.top(window.ops),
                              "idle_gaps": devtrace.top(window.gaps)})
    else:
        done = [r for r in requests if r.ok]
        values = {
            "encode_x_realtime": sum(len(files[r.file].samples) for r in done)
            / config["sample_rate"] / window_s,
            "request_ms_p95": float(np.percentile([1000.0 * r.wall_s for r in requests], 95)),
            "setup_s": setup_s,
        }
        out.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                            for m in bench["end_to_end"]
                            if name in m.get("workloads", [name])},
                   device=device_info)
    out["checks"] = checks
    out["_checked"] = picked
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 3
    checked = out.pop("_checked")
    print(f"requests {out['attempted']} failed {out['failed']} checked files {checked}",
          file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
