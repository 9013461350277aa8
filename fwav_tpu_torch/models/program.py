"""The encode program captured per shape key: the counterpart of the JAX
package's compiled-program cache (fwav_tpu/models/encode.py `_encode_core`,
`_packed_encode_core` and the stream's shard core, jitted through
utils/aot_cache.py `cached_jit` and keyed by `_core_key`).

The JAX package compiles one executable per shape bucket and runs it for
every length in that bucket: a file's counts ride in as a device array,
`meta`. The port's program is the same eager torch ops and ctypes kernel
launches (models/encode.py); here it is captured once per key in a CUDA
graph (torch.cuda.CUDAGraph) and replayed, one graph launch where the
eager program makes some 240. Its inputs are static device buffers (the
raw samples, a shard's packed mask bits, `meta`), filled before each call
from pinned host memory by non-blocking copies. Nothing of a call's counts
is baked into the graph: the program reads them from `meta` on the device
(models/encode.py `_front_packed`, `_front_masked`; K2 reads n_valid from
device memory).

A key's first call runs the program eagerly and keeps nothing (a key
seen once, as a one-shot `compress` or a batch of all different lengths
makes, pays no capture and holds no memory). Its second call runs it
eagerly on a side stream (the warm-up PyTorch asks for before a capture;
its result is that call's result), then captures it; every later call
replays it. A capture that fails raises: no path falls back to the eager
program. The kernel library is loaded (and built, where it must be) by
the first call, before any capture.

`kernels.LAUNCHES` is counted in Python, so a replay bumps nothing by
itself: a program keeps the counts its warm-up made (the capture's own
calls are not counted, since they launch nothing) and adds them at each
replay, so that a call counts what the eager program counts.

Callers hold DEVICE_LOCK (below) from `load` through `launch`:
`launch` copies the graph's output into a fresh tensor on the stream
before it returns, so that another thread's replay of the same key cannot
overwrite codes not yet fetched; `fill` waits for the last copy out of the
pinned buffers before it writes them again. Fill and replay run on the
caller's current stream.

The cache holds at most GRAPH_CACHE_MAX programs and GRAPH_CACHE_BYTES of
their graphs' private memory pools, and evicts the least recently used
past either when a call loads its program (never that program; the pool
of a program captured by the call counts from the next call). A pool's
size is read once, after its capture; it grows with the file, the files
per stack and the plan: 26 MiB for a 10 s file's program, 248 MiB for a
minute's (the staged plan), 3,076 MiB for a stack of 16 one-minute files
(measured on an H100 by scripts/measure_program_pools.py, PERF.md §5).
`PROGRAMS.stats()` shows the first calls, captures, replays and
evictions, and per program its kernel, copy and memset nodes, its
launches, capture time and pool size.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time

import torch

from ..ops import kernels

#: One card, one queue: the device programs of concurrent callers (the
#: CLI's batch threads) run one at a time under this lock, as in the JAX
#: package; host work (WAV I/O, bank builds, refits, containers) stays
#: outside it. It also keeps the kernel wrappers' launch counters
#: (ops/kernels.py LAUNCHES) exact under threads.
DEVICE_LOCK = threading.Lock()

#: Programs kept: one per shape key (bucket, config, mode, device, files
#: per stack), the least recently used evicted past this count. A CLI
#: batch of 48 files of 1 to 60 s made 23 keys on the default config, 15
#: of them captured (scripts/compare_cli_wall.py, PERF.md §5): 32 hold
#: them all, with room.
GRAPH_CACHE_MAX = 32
#: Bytes of graph pools kept: a fifth of an 80 GB card, so that the eager
#: run of a new key keeps its room beside them (a stack of 16 one-minute
#: files holds gigabytes; PERF.md §5).
GRAPH_CACHE_BYTES = 16 << 30
#: Keys seen once (run eagerly, not captured) remembered, the least
#: recently seen forgotten past this count.
SEEN_MAX = 1024

#: Node kinds of a captured graph, as fwav_graph_node_kinds counts them.
NODE_KINDS = ("kernel", "copy", "memset", "other")


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """{kind: count} of a captured graph's nodes (NODE_KINDS); the graph
    must have been made with keep_graph=True."""
    from ..ops import _build

    lib = _build.load()
    cap = 1024
    while True:
        scratch = (ctypes.c_void_p * cap)()
        total = ctypes.c_longlong(0)
        counts = (ctypes.c_longlong * len(NODE_KINDS))()
        code = lib.fwav_graph_node_kinds(ctypes.c_void_p(graph.raw_cuda_graph()), scratch,
                                         cap, ctypes.byref(total), counts)
        if code != 0 and total.value > cap:
            cap = total.value
            continue
        _build.check(lib, code, "graph nodes")
        return dict(zip(NODE_KINDS, (int(c) for c in counts)))


def pool_bytes(graph: torch.cuda.CUDAGraph) -> int:
    """Bytes of the device memory segments of a graph's private pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class Program:
    """One device program, `build(*inputs) -> output tensor`, captured
    on its first launch, with its static inputs shaped and typed as the
    host arrays of that first call."""

    def __init__(self, device, host_inputs, build):
        self.device = torch.device(device)
        self.build = build
        self.inputs = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                        device=self.device) for a in host_inputs)
        self.pinned = tuple(torch.empty(a.shape, dtype=t.dtype, pin_memory=True)
                            for a, t in zip(host_inputs, self.inputs))
        self.filled = None
        self.graph = None
        self.output = None
        self.launches: dict = {}
        self.nodes: dict = {}
        self.warmup_s = self.capture_s = None
        self.replays = 0
        self.pool = 0  # bytes of the graph's pool, once captured

    def fill(self, host_inputs) -> None:
        """Copy the host arrays into the static inputs (through the pinned
        buffers, non-blocking, on the current stream)."""
        if self.filled is not None:
            self.filled.synchronize()  # the last copies out of `pinned` are done
        stream = torch.cuda.current_stream(self.device)
        for dst, pin, src in zip(self.inputs, self.pinned, host_inputs):
            if src.shape != tuple(pin.shape) or torch.from_numpy(src[:0]).dtype != pin.dtype:
                raise ValueError(f"program input {src.dtype} {src.shape} does not fit "
                                 f"{pin.dtype} {tuple(pin.shape)}")
            pin.numpy()[...] = src
            dst.copy_(pin, non_blocking=True)
        self.filled = torch.cuda.Event()
        self.filled.record(stream)

    def launch(self) -> torch.Tensor:
        """Run the program on the static inputs; returns a fresh tensor."""
        if self.graph is None:
            return self._capture()
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, v in self.launches.items():
            kernels.LAUNCHES[k] += v
        self.replays += 1
        return self.output.clone()

    def _capture(self) -> torch.Tensor:
        t0 = time.perf_counter()
        dev = self.device
        with torch.cuda.device(dev):
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            before = dict(kernels.LAUNCHES)
            with torch.cuda.stream(side):
                out = self.build(*self.inputs)
            current.wait_stream(side)
            out.record_stream(current)
            launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            t1 = time.perf_counter()
            # capture_begin itself: torch.cuda.graph() would first synchronize
            # and empty the device and pinned caches, which later calls pay for
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            capture = torch.cuda.Stream(dev)
            capture.wait_stream(current)
            counted = dict(kernels.LAUNCHES)
            try:
                with torch.cuda.stream(capture):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        output = self.build(*self.inputs)
                    finally:
                        graph.capture_end()
            finally:
                captured = {k: kernels.LAUNCHES[k] - counted[k] for k in counted}
                kernels.LAUNCHES.update(counted)  # a capture launches nothing
            current.wait_stream(capture)
            if captured != launches:
                raise RuntimeError(f"the capture launched {captured}, the eager run {launches}")
            graph.instantiate()
        self.graph, self.output, self.launches = graph, output, launches
        self.nodes = graph_nodes(graph)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        self.pool = pool_bytes(graph)
        return out

    def release(self) -> None:
        """Drop the graph and its pool once the device is done with them."""
        if self.graph is not None:
            torch.cuda.current_stream(self.device).synchronize()
        self.graph = self.output = None
        self.pool = 0

    def info(self, memory: bool = False) -> dict:
        out = {"nodes": dict(self.nodes), "launches": dict(self.launches),
               "warmup_s": self.warmup_s, "capture_s": self.capture_s,
               "replays": self.replays}
        if memory:
            out["pool_bytes"] = None if self.graph is None else self.pool
        return out


class FirstCall:
    """A key's first call: the program run eagerly on device copies of
    the host inputs, nothing captured or kept."""

    def __init__(self, device, host_inputs, build):
        self.build = build
        self.inputs = tuple(torch.from_numpy(a).to(device) for a in host_inputs)

    def launch(self) -> torch.Tensor:
        return self.build(*self.inputs)


class ProgramCache:
    """Programs by key, least recently used evicted past `capacity`
    programs or `max_bytes` of their pools (`Program.pool`).
    `make(device, host_inputs, build)` makes a program (Program). A key
    is captured on its second call: the keys seen once are remembered
    (the SEEN_MAX most recent), not captured; an evicted key starts
    over."""

    def __init__(self, capacity: int = GRAPH_CACHE_MAX, make=Program):
        self.capacity = capacity
        self.max_bytes = GRAPH_CACHE_BYTES
        self._make = make
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self.first_calls = self.captures = self.hits = self.evictions = 0

    def load(self, key, device, host_inputs, build):
        """What runs this call of `key`, with `host_inputs` (numpy arrays,
        the build's arguments in order) on the device: on the key's first
        call a FirstCall, else its program (made on a miss), most recent
        now, the inputs copied into its static inputs. Call its `launch()`
        next, under the same DEVICE_LOCK."""
        prog = self._entries.pop(key, None)
        if prog is None and key not in self._seen:
            self._seen[key] = None
            while len(self._seen) > SEEN_MAX:
                self._seen.popitem(last=False)
            self.first_calls += 1
            return FirstCall(device, host_inputs, build)
        if prog is None:
            del self._seen[key]
            prog = self._make(device, host_inputs, build)
            self.captures += 1
        else:
            self.hits += 1
        self._entries[key] = prog
        while len(self._entries) > 1 and (
                len(self._entries) > self.capacity
                or sum(p.pool for p in self._entries.values()) > self.max_bytes):
            _, old = self._entries.popitem(last=False)
            old.release()
            self.evictions += 1
        prog.fill(host_inputs)
        return prog

    def keys(self) -> list:
        """Keys from the least to the most recently used."""
        return list(self._entries)

    def clear(self) -> None:
        for prog in self._entries.values():
            prog.release()
        self._entries.clear()
        self._seen.clear()
        self.first_calls = self.captures = self.hits = self.evictions = 0

    def stats(self, memory: bool = False) -> dict:
        """Counts of the cache (first calls: keys run once eagerly), and
        per program (least recently used first) its key, graph nodes by
        kind, launches per run, the seconds of its warm-up (the eager run
        of the capturing call) and of its capture and instantiation,
        replays and, with `memory`, its pool's bytes."""
        return {"capacity": self.capacity, "max_bytes": self.max_bytes,
                "entries": len(self._entries),
                "first_calls": self.first_calls,
                "captures": self.captures, "replays": self.hits,
                "evictions": self.evictions,
                "programs": [{"key": k, **p.info(memory)} for k, p in self._entries.items()]}


#: The process's programs (models/encode.py and models/stream.py).
PROGRAMS = ProgramCache()
