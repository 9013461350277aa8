"""The device mesh of the port: a (dp, tp) array of torch devices.

The counterpart of fwav_tpu/parallel/mesh.py. JAX drives every device of a
mesh from one process (shard_map); the port keeps that single-controller
form. A `Mesh` is a (dp, tp) array of `torch.device` cells and the process
that owns each. A mesh program (models/encode.py, models/decode.py) enqueues
each cell's work on its own device: cells on distinct cards overlap, since
launches are asynchronous, and cells that share a card run one after
another. The tp merge and the coarse tp gather are copies to the cell that
merges, inside one process.

- dp: each dp row takes a contiguous slab of ranges, with no communication;
- tp: for "exact" and "topk" each cell of a row scans a contiguous row
  shard of the bank and the row merges the shards' winners; under
  "coarse" tp splits the row's ranges again.

One device is the one-cell mesh (`as_mesh`), so every entry point runs
one program whether it was given a mesh or a device. A mesh may repeat a
device (`Mesh([["cpu"] * 2] * 2)`, or four cells on one card): the analog
of the JAX tests' virtual host devices, and how one card runs a (2, 2)
mesh. `make_mesh(device="cpu")` gives n CPU cells.

Several processes: `init_distributed` joins a gloo process group on the
host and returns the global mesh, laid out in process order as JAX's
make_mesh lays out jax.devices(); each process runs the cells it owns, and
`fetch_global` all-gathers the processes' code slabs on the host (the codes
go to the host anyway, so no NCCL is needed, and two processes may share
one card). A tp row must lie within one process: a row whose cells belong
to several raises ValueError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"

#: After init_distributed: (this process's id, [(owner process, device
#: label)] of every device of the group, in process order).
_WORLD = None


class Mesh:
    """A (dp, tp) array of torch devices. `devices` is a nested sequence (or
    array) of devices or their names, (dp, tp) or (dp,) for tp = 1;
    `owners` the process of each cell (all 0 by default) and
    `process_index` this process's. `shape` maps DP_AXIS and TP_AXIS to
    their sizes, as a JAX mesh's does."""

    def __init__(self, devices, owners=None, process_index: int = 0):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) array, got shape {arr.shape}")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos, d in np.ndenumerate(arr):
            self.devices[pos] = torch.device(d)
        self.owners = (np.zeros(arr.shape, dtype=np.int64) if owners is None
                       else np.asarray(owners, dtype=np.int64).reshape(arr.shape))
        self.process_index = int(process_index)
        for pos, d in np.ndenumerate(self.devices):
            if self.owners[pos] == self.process_index:
                resolve_device(d)
                if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                    raise ValueError(f"{d} is not a device of this process")
        self.shape = {DP_AXIS: arr.shape[0], TP_AXIS: arr.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_process(self) -> bool:
        return len(np.unique(self.owners)) > 1

    def local_cells(self):
        """Flat positions (i * tp + j) of the cells this process owns."""
        return [k for k, o in enumerate(self.owners.reshape(-1)) if o == self.process_index]

    def local_rows(self):
        """The dp rows this process runs; ValueError where a tp row spans
        processes (its merge would need a collective between them)."""
        rows = []
        for i, own in enumerate(self.owners):
            if len(np.unique(own)) > 1:
                raise ValueError(
                    f"dp row {i} of the mesh spans processes {sorted(set(own.tolist()))}: "
                    "a tp row must lie within one process (give each process a "
                    "multiple of tp devices)"
                )
            if own[0] == self.process_index:
                rows.append(i)
        return rows

    def first_local_device(self) -> torch.device:
        return self.devices.reshape(-1)[self.local_cells()[0]]

    def __repr__(self):
        return (f"Mesh(dp={self.shape[DP_AXIS]}, tp={self.shape[TP_AXIS]}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]})")


def as_mesh(mesh, device) -> Mesh:
    """`mesh`, or where it is None the one-cell mesh of `device`: the
    single-device path of every entry point that takes a mesh. A mesh
    decides the devices: `device` is then not used."""
    return mesh if mesh is not None else Mesh([[resolve_device(device)]])


def make_mesh(n_devices=None, dp=None, tp=1, device="cuda") -> Mesh:
    """(dp, tp) mesh over the first n_devices devices: the cards
    (torch.cuda.device_count()) for device "cuda", n CPU cells (1 by
    default) for "cpu", or, after init_distributed, every device of the
    process group in process order. dp defaults to n_devices // tp.
    Raises ValueError when fewer devices are present than requested."""
    if _WORLD is not None:
        process_index, world = _WORLD
        avail = [d for _, d in world]
        owners = [o for o, _ in world]
        backend = "distributed"
    else:
        kind = torch.device(device).type
        if kind == "cuda":
            avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif kind == "cpu":
            avail = None
        else:
            raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
        process_index, owners, backend = 0, None, kind
    if avail is None:
        n = n_devices or 1
        avail = [torch.device("cpu")] * n
    n = n_devices or len(avail)
    if n > len(avail):
        raise ValueError(
            f"requested {n} devices but only {len(avail)} are available ({backend} backend)"
        )
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp * tp must equal the device count (dp={dp}, tp={tp}, n={n})")
    return Mesh(np.asarray(avail[:n], dtype=object).reshape(dp, tp),
                owners=None if owners is None else np.asarray(owners[:n]).reshape(dp, tp),
                process_index=process_index)


def fetch_global(parts: dict, mesh: Mesh | None = None) -> np.ndarray:
    """A mesh program's slabs on the host: `parts` {position: tensor or
    array} of this process's slabs is copied and, where `mesh` spans
    several processes, all-gathered over the host group so that every
    process holds every slab; the slabs are concatenated along axis 0 in
    position order."""
    parts = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
             for k, v in parts.items()}
    if mesh is not None and mesh.multi_process:
        import torch.distributed as dist

        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, parts)
        parts = {k: v for got in gathered for k, v in got.items()}
    return np.concatenate([parts[k] for k in sorted(parts)], axis=0)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     device="cuda", local_devices=None) -> Mesh:
    """Join the processes of a multi-process mesh: a gloo process group
    on the host (torch.distributed.init_process_group), with the JAX
    package's defaults from the environment (JAX_COORDINATOR_ADDRESS
    "host:port", JAX_NUM_PROCESSES, JAX_PROCESS_ID). Call once per process
    before any mesh work. Each process brings its local devices: every card
    for device "cuda", one CPU cell for "cpu"; `local_devices` overrides
    that with a count (the first n cards, or n CPU cells) or a list of
    devices (two processes may both name "cuda:0"). Returns make_mesh()
    over every process's devices in process order."""
    global _WORLD

    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if addr is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and "
                         "process_id (or JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and "
                         "JAX_PROCESS_ID)")
    kind = torch.device(device).type
    if local_devices is None:
        local_devices = torch.cuda.device_count() if kind == "cuda" else 1
    if isinstance(local_devices, int):
        local_devices = ([torch.device("cuda", i) for i in range(local_devices)]
                         if kind == "cuda" else [torch.device("cpu")] * local_devices)
    local = [str(resolve_device(d)) for d in local_devices]
    if kind == "cuda" and len(local) > torch.cuda.device_count():
        raise ValueError(f"requested {len(local)} local cards but only "
                         f"{torch.cuda.device_count()} are available")
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=int(num_processes), rank=int(process_id),
        )
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    _WORLD = (int(process_id),
              [(p, torch.device(d)) for p, devs in enumerate(gathered) for d in devs])
    return make_mesh()
