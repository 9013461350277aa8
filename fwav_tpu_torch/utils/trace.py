"""Phase timing and profiler traces (copied from fwav_tpu/utils/trace.py,
with torch.profiler in place of the JAX profiler).

Every pipeline stage is timed into a per-thread phase table, under the JAX
package's names: `device`, `d2h` and `host_bank` around a stack's device
program, `vad` and `refit` in its host half; `vad`, `dispatch`,
`fetch_wait`, `host_refit` and, for the damped global pass, `global_pass`,
`global_h2d`, `global_dispatch` and `global_fetch` in the stream. A phase is
a host-clock time: on the card `device` is the enqueue of the stack's
kernels plus the wait for its codes, not the card's busy time. The busy
time is the sum of the kernels' durations in a `torch_profile` trace, in
which each phase is also a range named `phase.<name>`.

Usage:
    with collect_phases() as phases:
        compress_audio_arrays(...)   # stages call phase("device"), ...
    print(phases)  # {"device": 0.012, "d2h": 0.009, ...} in seconds

    with torch_profile("trace_dir"):  # TensorBoard-compatible trace
        compress_audio_arrays(...)
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_local = threading.local()


@contextlib.contextmanager
def collect_phases():
    """Collect the phase times recorded by `phase(...)` in this thread."""
    prev = getattr(_local, "phases", None)
    _local.phases = {}
    try:
        yield _local.phases
    finally:
        _local.phases = prev


def add_phase(name: str, seconds: float) -> None:
    """Add a time measured by the caller to `name` in this thread's table;
    nothing without a collector. For stages whose boundaries another
    timer reads as well (models/stream.py), so that both read one clock."""
    sink = getattr(_local, "phases", None)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + seconds


@contextlib.contextmanager
def phase(name: str):
    """Time a pipeline stage (repeated names add up), inside the profiler
    range `phase.<name>`. It records nothing when no collector is active
    in this thread."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(f"phase.{name}"):
            yield
    finally:
        add_phase(name, time.perf_counter() - t0)


@contextlib.contextmanager
def torch_profile(logdir):
    """A torch.profiler trace of the block (CPU activity, and CUDA activity
    where a card is present), written to `logdir` in TensorBoard's format.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
        acc_events=True,  # events() keeps them after the trace is written
    ) as prof:
        yield prof
