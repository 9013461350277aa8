"""Phase timing and profiler traces (copied from fwav_tpu/utils/trace.py,
with torch.profiler in place of the JAX profiler).

Every pipeline stage is timed into a per-thread phase table. The JAX
package's names come first: `device`, `d2h` and `host_bank` around a
stack's device program, `vad` and `refit` in its host half; `vad`,
`dispatch`, `fetch_wait`, `host_refit` and, for the damped global pass,
`global_pass`, `global_h2d`, `global_dispatch` and `global_fetch` in the
stream. The port also names the stages the JAX package leaves unnamed:
`prep` (the signal's preparation for the device: buckets, padded copy,
16-bit probe; the stream's also its silence test), the file API's
`wav_read`, `prune`, `container` (the v2 writer's `container_entropy` and
`container_deflate` inside it) and `write`, and the stream's `shard_prep`
and `global_refit`. `PARENT` says how the phases nest. A phase is a
host-clock time: on the card `device` is the enqueue of the stack's
kernels plus the wait for its codes, not the card's busy time. The busy
time is the sum of the kernels' durations in a `torch_profile` trace, in
which each phase is also a range named `phase.<name>`. The range is opened
only while a profiler records, so that otherwise a phase costs two clock
reads and a table update.

Beside the phases the program keeps counters (fwav_tpu_torch/ops/
kernels.py): `LAUNCHES`, kernel launches per kernel; `BANK_BUILDS`, banks
by where they were built; `PACKS`, the packing of compress_audio_packed:
its calls and clips, its stacks and their files (one `device`, `d2h` and
`host_bank` a stack, one `prep` and `refit` a file), and the valid and the
bucketed pairs of each stack's scan grid.

Usage:
    with collect_phases() as phases:
        compress_audio_arrays(...)   # stages call phase("device"), ...
    print(phases)  # {"device": 0.012, "d2h": 0.009, ...} in seconds
    # what no phase covers: the call's wall time less
    # sum(t for name, t in phases.items() if name not in PARENT)

    with torch_profile("trace_dir"):  # TensorBoard-compatible trace
        compress_audio_arrays(...)
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_local = threading.local()

#: The phase that encloses each nested phase, wherever both run; a phase
#: not named here is outermost. The outermost phases of a call never
#: overlap, so its wall time less their sum is the time no phase covers.
PARENT = {
    "d2h": "device",
    "host_bank": "d2h",
    "global_h2d": "global_pass",
    "global_dispatch": "global_pass",
    "global_fetch": "global_pass",
    "container_entropy": "container",
    "container_deflate": "container",
}


@contextlib.contextmanager
def collect_phases():
    """Collect the phase times recorded by `phase(...)` in this thread."""
    prev = getattr(_local, "phases", None)
    _local.phases = {}
    try:
        yield _local.phases
    finally:
        _local.phases = prev


@contextlib.contextmanager
def phase(name: str, clock=time.perf_counter):
    """Time a pipeline stage (repeated names add up): `clock()` after the
    block less `clock()` before it, added to `name` in this thread's
    table; nothing without a collector. While a profiler records, the
    block is also the range `phase.<name>`. A stage whose boundaries
    another timer reads too passes that timer's clock (models/stream.py),
    so that both read the same instants. Usable as a decorator."""
    t0 = clock()
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(f"phase.{name}"):
                yield
        else:
            yield
    finally:
        sink = getattr(_local, "phases", None)
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + (clock() - t0)


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
