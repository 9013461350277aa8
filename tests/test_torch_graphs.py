"""The port's device program per shape key (models/program.py, the
counterpart of the JAX package's cached_jit per _core_key) on the CPU.

A CUDA graph is captured and replayed only on the card
(tests/test_torch_cuda.py and chip_smoke.py's graphs phase hold replays to
eager runs there); what it needs of the program is checked here:
- the cache key is the JAX package's _core_key, use_pallas left out, with
  the device and the files per stack after it;
- the program reads its counts from the device `meta` and K2's and K4's
  n_valid from a device tensor, and reads no tensor on the host (a read would be a
  sync inside a capture and a value baked into the graph): every
  Tensor-to-host method raises while the program runs here;
- its codes equal those of the host-int forms it replaced (the shard's
  range offset sliced on the host, K2's and K4's n_valid as ints), for two
  lengths of one bucket, one key, as a single file, a packed stack and a
  shard, under the plans exact, coarse-window and coarse-staged;
- the cache's bound: least recently used programs are evicted, against a
  stub program.
Bar: codes equal exactly (the same float32 arithmetic on the same device).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import bench
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.models.encode import _core_key as jax_core_key
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.models import program
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)


# --- the key -------------------------------------------------------------------


@pytest.mark.parametrize("tile", [256, 1024, 2048, 4352, 8192, 16384])
@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_core_key_is_the_jax_packages(tile, objective):
    """Over searches, lobe counts, bank sizes (exact and coarse under
    "auto"), modes and transfer types: the JAX key without use_pallas,
    then the device and the stack size."""
    damped_topc = set()
    for search in ("auto", "exact", "coarse", "topk"):
        for topc in (1, 2):
            jcfg = JaxEncoderConfig(use_pallas=True, tile_size=tile, objective=objective,
                                    search=search, coarse_topc=topc)
            cfg = EncoderConfig.from_reference(dataclasses.asdict(jcfg))
            for db in (4096, 32768, 458752):
                for mode in ("raw", "masked", "global"):
                    for in_i16 in (False, True):
                        want = jax_core_key(jcfg, 8192, 4096, db, mode, in_i16)
                        got = port_encode._core_key(cfg, 8192, 4096, db, mode, in_i16,
                                                    "cpu", 3)
                        assert want[16] is True  # use_pallas
                        assert got == (*want[:16], *want[17:], "cpu", 3)
                        if mode == "raw" and got[6] == "coarse":
                            damped_topc.add(got[15])
    if objective == "damped":
        assert damped_topc == {4}  # the damped profile's lobes


def test_core_key_separates_devices_and_stacks():
    cfg = EncoderConfig()
    key = port_encode._core_key(cfg, 442368, 442368, 458752, "raw", True, "cuda", 1)
    assert key[-2:] == ("cuda", 1)
    assert key != port_encode._core_key(cfg, 442368, 442368, 458752, "raw", True, "cuda:1", 1)
    assert key != port_encode._core_key(cfg, 442368, 442368, 458752, "raw", True, "cuda", 2)


# --- no host value in the program ------------------------------------------------

#: Every way a tensor's value reaches the host.
_HOST_READS = ("item", "tolist", "numpy", "cpu", "__int__", "__index__", "__bool__",
               "__float__")


@contextlib.contextmanager
def no_host_reads():
    """Every Tensor-to-host method raises inside the block."""
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"the program read a tensor on the host: Tensor.{name}")
        return read

    try:
        for name in _HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)


def test_no_host_reads_refuses():
    with no_host_reads(), pytest.raises(AssertionError, match="Tensor.item"):
        torch.zeros(1).item()
    assert torch.ones(1).item() == 1.0


@contextlib.contextmanager
def k2_host_ints(monkeypatch):
    """K2 and K4 as they were called before: n_valid as host ints (K4's
    plain version takes them; the staged refine took one int per file)."""
    real, real4 = kernels.refine_window, kernels.staged_refine

    def host(means_ext, lobes, ranges, n_valid, *a, **k):
        return real(means_ext, lobes, ranges, [int(v) for v in n_valid], *a, **k)

    def host4(ranges, bank, n_valid, *a, **k):
        return real4(ranges, bank, [int(v) for v in n_valid], *a, **k)

    with monkeypatch.context() as m:
        m.setattr(port_encode, "refine_window", host)
        m.setattr(port_encode, "staged_refine", host4)
        yield


def _front_masked_host(raw, mask_bytes, meta, lb, cfg):
    """The shard's front as it was: meta as host ints, the range offset
    clamped and sliced on the host."""
    n = cfg.range_size
    _, offset, n_ranges, n_domains = (int(v) for v in meta)
    rawf, inv, weighted = port_encode._mask_weighted(raw, mask_bytes)
    off = min(max(offset, 0), raw.shape[0] - lb)
    ranges = weighted[off : off + lb].reshape(1, lb // n, n)
    return (ranges, (rawf * inv)[None], torch.tensor([n_ranges]), torch.tensor([n_domains]),
            inv[None])


#: Two lengths of one bucket at 44.1 kHz: at the default tile the same
#: (nb, lb, db) = (32768, 8192, 32768), so the same key; 32,768 bank rows
#: take the coarse search with the window refine; at tile 512 (coarse
#: stride 64) the staged refine, K4.
_LENGTHS = (30000, 32000)
_KW = {"balanced": {}, "damped": {"objective": "damped"},
       "exact": {"search": "exact"}, "staged": {"tile_size": 512},
       "staged_damped": {"tile_size": 512, "objective": "damped"}}
_PLAN = {"exact": ("exact", 128, None), "staged": ("coarse", 64, "staged"),
         "staged_damped": ("coarse", 64, "staged")}


def _two_files(kind):
    cfg = EncoderConfig(**_KW[kind])
    sig = bench.make_signal(1.0)
    files = [port_encode._prep_signal(sig[:n], cfg) for n in _LENGTHS]
    (raw0, nr0, nd0, lb, db), (raw1, nr1, nd1, lb1, db1) = files
    assert (len(raw0), lb, db) == (len(raw1), lb1, db1)
    keys = {port_encode._core_key(cfg, len(r[0]), lb, db, "raw", r[0].dtype == np.int16,
                                  "cpu") for r in files}
    assert len(keys) == 1
    plan = port_encode._plan_search(cfg, lb // cfg.range_size, db)
    assert plan == _PLAN.get(kind, ("coarse", 128, "window"))
    metas = [port_encode._stack_counts([n], [f[1]], [f[2]]) for n, f in zip(_LENGTHS, files)]
    return cfg, lb, db, [f[0] for f in files], metas


@pytest.mark.parametrize("kind", list(_KW))
def test_raw_program_reads_its_counts_on_the_device(monkeypatch, kind):
    """Single files and their stack: the device-meta program, run with no
    host read, gives each file the codes of the host-int form, one key for
    both lengths; the stack's codes are the singles'."""
    cfg, lb, db, raws, metas = _two_files(kind)
    singles = []
    for raw, meta in zip(raws, metas):
        raw_t, meta_t = torch.from_numpy(raw[None]), torch.from_numpy(meta)
        with no_host_reads():
            got = port_encode._program_raw(raw_t, meta_t, lb, db, cfg)
        if kind != "exact":  # K2 or K4 runs only after a coarse scan
            with k2_host_ints(monkeypatch):
                want = port_encode._program_raw(raw_t, meta_t, lb, db, cfg)
            assert torch.equal(got, want)
        assert (got[0, :, 0] != 0xFF).any()
        singles.append(got[0])
    stack = torch.from_numpy(np.stack(raws))
    with no_host_reads():
        packed = port_encode._program_raw(stack, torch.from_numpy(np.concatenate(metas)),
                                          lb, db, cfg)
    assert torch.equal(packed, torch.stack(singles))
    assert not torch.equal(singles[0], singles[1])


#: The shards' configurations: the window refine, and the staged refine
#: at tile 512 (4 taps, coarse stride 64) and tile 2048 (8 taps, domain_step 2).
_SHARD_KW = {"balanced": ({}, ("coarse", 128, "window")),
             "damped": ({"objective": "damped"}, ("coarse", 128, "window")),
             "staged_damped": ({"tile_size": 512, "objective": "damped"},
                               ("coarse", 64, "staged")),
             "staged_tile2048": ({"tile_size": 2048}, ("coarse", 128, "staged"))}


@pytest.mark.parametrize("kind", list(_SHARD_KW))
@pytest.mark.parametrize("offset", [12000, 40000])
def test_shard_program_reads_its_counts_on_the_device(monkeypatch, kind, offset):
    """A shard window: the range offset applied on the device with the
    clamp of lax.dynamic_slice (40,000 is past nb - lb and clamps), no
    host read; codes equal the host-int form's for two window lengths."""
    kw, plan = _SHARD_KW[kind]
    cfg = EncoderConfig(**kw)
    sig = bench.make_signal(2.0)
    nb, lb, db = 65536, 32768, 65536
    n = cfg.range_size
    assert port_encode._plan_search(cfg, lb // n, db) == plan
    codes = []
    for lenw in (60000, 58000):
        raw_p = np.zeros(nb, np.int16)
        raw_p[:lenw] = sig[:lenw]
        voiced = np.zeros(nb, np.uint8)
        voiced[:lenw] = (np.abs(sig[:lenw]) > 200).astype(np.uint8)
        mask = np.packbits(voiced, bitorder="little")
        meta = np.array([lenw, offset, lb // n - 5, lenw - cfg.tile_size + 1], np.int32)
        raw_t, mask_t = torch.from_numpy(raw_p), torch.from_numpy(mask)
        with no_host_reads():
            got = port_encode._mesh_program(
                Mesh([["cpu"]]),
                lambda d: port_encode._front_masked(raw_t, mask_t, torch.from_numpy(meta),
                                                    lb, cfg),
                lb, db, cfg)[0]
        with k2_host_ints(monkeypatch):
            want = port_encode._mesh_program(
                Mesh([["cpu"]]), lambda d: _front_masked_host(raw_t, mask_t, meta, lb, cfg),
                lb, db, cfg)[0]
        assert torch.equal(got, want)
        assert (got[0, :, 0] != 0xFF).any()
        codes.append(got)
    assert not torch.equal(codes[0], codes[1])


def test_refine_window_ref_takes_the_device_tensor():
    """refine_window_ref with n_valid as ints and as an int32 tensor, one
    file and a stack: the same bits."""
    rng = np.random.default_rng(3)
    B, M, n, stride, block_len, dc = 3, 300, 4, 128, 256, 24
    L = port_encode._means_ext_len(n, block_len, stride, dc)
    ext = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    lobes = torch.from_numpy(rng.integers(-1, dc, (B, M, 2)).astype(np.int32))
    ranges = torch.from_numpy(rng.standard_normal((B, M, n)).astype(np.float32))
    n_valid = [dc * stride - 900 * b for b in range(B)]
    for objective in ("balanced", "affine", "damped"):
        args = (stride, block_len, objective, 2.0)
        want = kernels.refine_window_ref(ext, lobes, ranges, n_valid, *args)
        got = kernels.refine_window_ref(ext, lobes, ranges,
                                        torch.tensor(n_valid, dtype=torch.int32), *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        one = kernels.refine_window_ref(ext[2], lobes[2], ranges[2],
                                        torch.tensor([n_valid[2]], dtype=torch.int32), *args)
        assert torch.equal(one[1], want[1][2]) and torch.equal(one[0], want[0][2])
        assert int(want[1][2].max()) <= n_valid[2] - 1


def test_refine_lead_check_runs_on_host_ints():
    """K2's size check, on the counts of every call (models/encode.py
    _check_counts before the program, eager or replayed)."""
    kernels.check_refine_lead(1000, [800, 872], 128)
    with pytest.raises(ValueError, match="fewer than the stride-wide lead"):
        kernels.check_refine_lead(1000, [800, 873], 128)
    cfg = EncoderConfig()
    port_encode._check_counts(cfg, 8192, 32768, [32768])
    L = port_encode._means_ext_len(4, 256, 128, 256)
    with pytest.raises(ValueError, match="fewer than the stride-wide lead"):
        port_encode._check_counts(cfg, 8192, 32768, [L - 127])


# --- which programs are captured ---------------------------------------------------


class _Cells:
    """A mesh's shape and first device (parallel/mesh.py Mesh checks that
    its cards exist, and a machine without a card has none)."""

    def __init__(self, size, device):
        self.size, self.multi_process, self.device = size, False, torch.device(device)

    def first_local_device(self):
        return self.device


def test_captured_plans():
    """exact, coarse-window and coarse-staged on one card; topk, a CPU
    device and a mesh of several cells stay eager."""
    one = _Cells(1, "cuda")
    default = EncoderConfig()
    assert port_encode._captured(default, 442368, 458752, one)  # 10 s: coarse, window
    assert port_encode._captured(EncoderConfig(objective="damped"), 442368, 458752, one)
    assert port_encode._captured(default, 32768, 24576, one)  # exact
    assert port_encode._captured(EncoderConfig(tile_size=512), 442368, 458752, one)  # staged
    assert port_encode._captured(EncoderConfig(tile_size=512, objective="damped"), 442368,
                                 458752, one)
    assert port_encode._captured(default, 3145728, 3145728, one)  # 60 s: staged
    assert not port_encode._captured(EncoderConfig(search="topk"), 442368, 458752, one)
    assert not port_encode._captured(default, 442368, 458752, Mesh([["cpu"]]))
    assert not port_encode._captured(default, 442368, 458752, _Cells(2, "cuda"))


# --- the cache's bound ---------------------------------------------------------------


class _Stub:
    """A program that records what the cache does with it."""

    made = []

    def __init__(self, device, host_inputs, build):
        self.build, self.fills, self.released = build, [], False
        self.pool = 0
        _Stub.made.append(self)

    def fill(self, host_inputs):
        self.fills.append(host_inputs[0].copy())

    def launch(self):
        return self.build(*self.fills[-1:])

    def release(self):
        self.released = True

    def info(self, memory=False):
        return {"fills": len(self.fills)}


def test_cache_evicts_the_least_recently_used():
    """A key's first call runs eagerly and keeps nothing, its second
    captures (makes a program), later calls replay it; past the capacity
    the least recently used program goes, and its key starts over."""
    _Stub.made.clear()
    cache = program.ProgramCache(capacity=2, make=_Stub)

    def run(key, x):
        return cache.load(key, "cpu", (np.array([x]),), lambda a: a * 10).launch()

    assert run("a", 1)[0] == 10 and run("b", 2)[0] == 20  # first calls
    assert not _Stub.made and cache.keys() == []
    assert run("a", 3)[0] == 30 and run("b", 4)[0] == 40  # captured
    assert run("a", 5)[0] == 50  # a replays, and is now the most recent
    assert run("c", 6)[0] == 60 and len(_Stub.made) == 2  # c's first call
    assert run("c", 7)[0] == 70  # captured; evicts b
    a, b, c = _Stub.made
    assert b.released and not a.released and not c.released
    assert cache.keys() == ["a", "c"]
    assert run("b", 8)[0] == 80 and len(_Stub.made) == 3  # evicted: eager again
    assert run("b", 9)[0] == 90  # made anew; evicts a
    assert a.released and len(_Stub.made) == 4
    st = cache.stats()
    assert (st["first_calls"], st["captures"], st["replays"], st["evictions"],
            st["entries"]) == (4, 4, 1, 2, 2)
    assert [p["key"] for p in st["programs"]] == ["c", "b"]
    assert [p["fills"] for p in st["programs"]] == [1, 1]
    cache.clear()
    assert cache.stats()["entries"] == 0 and c.released


def test_cache_evicts_past_its_pool_bytes():
    """Past `max_bytes` of the programs' pools the least recently used
    programs go, however few they are; the program of the running call
    stays, even alone over the bound."""
    _Stub.made.clear()
    cache = program.ProgramCache(capacity=8, make=_Stub)
    cache.max_bytes = 100

    def run(key, pool=None):
        prog = cache.load(key, "cpu", (np.array([1]),), lambda a: a)
        prog.launch()
        if pool is not None:
            prog.pool = pool  # what a capture reads
        return prog

    for key, pool in (("a", 40), ("b", 50)):
        run(key)
        run(key, pool)  # captured: 90 bytes in all
    a, b = _Stub.made
    run("c")
    run("c", 30)  # loaded at 90, captured: 120 from the next call on
    assert cache.keys() == ["a", "b", "c"] and cache.stats()["evictions"] == 0
    run("b")  # 120 > 100: a goes
    assert a.released and cache.keys() == ["c", "b"]
    run("d")
    run("d", 500)  # alone over the bound
    run("d")
    assert cache.keys() == ["d"] and cache.stats()["evictions"] == 3
    assert cache.stats()["max_bytes"] == 100


def test_cache_forgets_the_oldest_keys_seen_once(monkeypatch):
    """Keys seen once are remembered up to SEEN_MAX; a forgotten key's
    next call is a first call again."""
    monkeypatch.setattr(program, "SEEN_MAX", 2)
    _Stub.made.clear()
    cache = program.ProgramCache(capacity=4, make=_Stub)

    def run(key):
        return cache.load(key, "cpu", (np.array([1]),), lambda a: a).launch()

    for key in ("a", "b", "c", "a"):  # a is forgotten when c is seen
        run(key)
    assert not _Stub.made and cache.stats()["first_calls"] == 4
    run("c")
    assert len(_Stub.made) == 1 and cache.keys() == ["c"]


def test_cache_capacity_is_named():
    assert program.PROGRAMS.capacity == program.GRAPH_CACHE_MAX == 32
    assert program.PROGRAMS.max_bytes == program.GRAPH_CACHE_BYTES == 16 << 30


def test_cpu_encode_captures_nothing():
    """Programs are captured on the card only: a CPU encode leaves the
    process's cache as it was."""
    before = program.PROGRAMS.stats()
    port_encode.compress_audio_arrays(bench.make_signal(0.8), 44100, 2, device="cpu")
    assert program.PROGRAMS.stats() == before


# --- K2 stops at 16 taps, and never sees more -------------------------------------


@pytest.mark.parametrize("tile", [4352, 8192, 16384, 32768, 65280])
def test_wide_ranges_never_reach_the_window_refine(tile):
    """A range size over 16 comes with domain_step > 1, which the window
    refine's gate refuses: every plan is exact or the staged refine, so
    K2 and its table (N <= 16) never see it; the wrapper's message says so."""
    for objective in ("balanced", "damped"):
        cfg = EncoderConfig(tile_size=tile, objective=objective)
        assert cfg.range_size > 16 and cfg.domain_step > 1
        for db in (4096, 65536, 458752, 2621440):
            if db % 128:
                continue
            mode, stride, refine = port_encode._plan_search(cfg, 114688, db)
            assert refine != "window", (tile, db)
    assert "range sizes 4..16" in kernels._K2_RANGE_NOTE
    assert "staged refine" in kernels._K2_RANGE_NOTE
    assert 17 in kernels._SCAN_N and 255 in kernels._SCAN_N and 256 not in kernels._SCAN_N
    assert 17 not in kernels._KERNEL_N
