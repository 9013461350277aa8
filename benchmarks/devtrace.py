"""Reading a torch.profiler trace of a window of requests: the card's
busy time, each kernel's time by symbol, the operations that took most
time and the longest idle gaps by what the host was doing in them.

The card's records are its kernels, copies and memsets; a replayed CUDA
graph leaves one record per work node. The profiler is known to lose the
first records of a block begun on an idle card, so `padded` keeps the card
working for a moment before the block (a one-element add and a sync every
few milliseconds) and the block's records are those that start after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

#: Prefixes of profiler ranges (record_function) that are annotations,
#: not work: the program's phases and stream ranges, and the requests.
ANNOTATIONS = ("phase.", "stream.", "bench.")
WARM_S = 0.3
PROBE_S = 0.005


@contextlib.contextmanager
def padded():
    """A CPU and CUDA torch.profiler over the block, entered
    WARM_S before it with the card kept working. Yields a dict that holds,
    after the block, the profiler ("prof") and the block's start and end
    in the trace's clock ("t0_ns", "t1_ns")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        while time.perf_counter() - t < WARM_S:
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(PROBE_S)
        out["t0_ns"] = time.time_ns()
        yield out
        torch.cuda.synchronize()
        out["t1_ns"] = time.time_ns()
    out["prof"] = prof


@dataclasses.dataclass
class Window:
    """What a traced block shows."""

    window_s: float
    busy_s: float
    ops: dict            # device op name -> seconds
    gaps: dict           # what the host did -> idle seconds

    def kernel_seconds(self, symbols) -> float:
        """Seconds of the device ops whose name holds one of `symbols`."""
        return sum(s for name, s in self.ops.items() if any(k in name for k in symbols))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(traced: dict) -> Window:
    """Reduce a `padded` block's trace to a Window."""
    from torch.autograd import DeviceType

    t0, t1 = traced["t0_ns"], traced["t1_ns"]
    events = list(traced["prof"].profiler.kineto_results.events())
    dev, host = [], []
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if start < t0 or start > t1:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(ANNOTATIONS):
                dev.append((start, start + dur, name))
        elif name.startswith(("phase.", "bench.")):
            host.append((start, start + dur, name))
    ops: dict = {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
    busy = _merge([(a, min(b, t1)) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps: dict = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        what = min(inside)[1] if inside else "between_requests"
        gaps[what] = gaps.get(what, 0.0) + (b - a) / 1e9
    return Window((t1 - t0) / 1e9, busy_s, ops, gaps)


def top(d: dict, k: int = 10) -> list:
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
