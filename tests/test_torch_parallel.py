"""The port's multi-device encode and decode on CPU cells, against its own
single-device runs and against the JAX package's sharded runs on its 8
virtual CPU devices.

A `Mesh` of CPU cells (fwav_tpu_torch/parallel/mesh.py) that repeats the
host device runs every cell's program one after another, as cells that
share one card do. Bars:

- the port's records at (dp, tp) in {(2, 1), (4, 1), (1, 2), (2, 2),
  (4, 2)} equal its single-device records byte for byte, for coarse (one
  lobe and damped), exact and topk; so do the sharded stream, the packed
  stack over 4 cells and the two-process gloo loopback;
- against fwav_tpu's compress_audio_sharded at one (dp, tp) per mode: the
  ROADMAP parity bar (the same sentinel set, idx equal but at near-ties,
  SNR within 0.01 dB; tests/test_torch_encode.py _assert_encode_bar and
  tests/test_torch_topk.py assert_topk_bar);
- merge_shard_bests equal to the JAX one under shard_map on planted ties;
  a bank row shard equal to build_bank_jax's; the all-invalid bank -inf;
- the damped decode over dp 4: each slab decodes as it does alone, within
  float tolerance of the JAX package's sharded decode, with its per-shard
  iteration counts.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_pallas_sharded import _sig
from test_torch_encode import _assert_encode_bar
from test_torch_topk import assert_topk_bar

import fwav_tpu_torch as port
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.models import decode as jax_decode_mod
from fwav_tpu.ops.domains import build_bank_jax
from fwav_tpu.ops.search import merge_shard_bests as jax_merge
from fwav_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fwav_tpu.parallel.shard import compress_audio_sharded as jax_sharded
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models import encode as port_encode
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.ops.domains import build_bank
from fwav_tpu_torch.ops.search import merge_shard_bests
from fwav_tpu_torch.parallel import Mesh, compress_audio_sharded, fetch_global, make_mesh
from fwav_tpu_torch.utils.buckets import bucket, pad_to
from native_libs import ensure_native_libraries

ensure_native_libraries()

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MESHES = [(2, 1), (4, 1), (1, 2), (2, 2), (4, 2)]
#: mode -> (samples of _sig at 16 kHz, encoder settings); "coarse" is the
#: one-lobe K1 + K2 path, "damped" K3 + K2, "exact" K1 over the bank.
MODES = {
    "coarse": (16000, dict(search="coarse")),
    "damped": (16000, dict(search="coarse", objective="damped")),
    "exact": (12000, dict(search="exact")),
    "topk": (6000, dict(search="topk")),
}
#: The (dp, tp) of each mode's run against the JAX package.
JAX_MESH = {"coarse": (2, 2), "damped": (4, 2), "exact": (2, 4), "topk": (2, 2)}
_CACHE = {}


def _cpu_mesh(dp, tp):
    return Mesh([["cpu"] * tp] * dp)


def _configs(mode):
    jcfg = JaxEncoderConfig(use_pallas=True, **MODES[mode][1])
    return jcfg, EncoderConfig.from_reference(dataclasses.asdict(jcfg))


def _single(mode):
    """(signal, the port's single-device result) of a mode, once."""
    if mode not in _CACHE:
        sig, sr = _sig(MODES[mode][0])
        _CACHE[mode] = (sig, port.compress_audio_arrays(sig, sr, 2, config=_configs(mode)[1],
                                                        device="cpu"))
    return _CACHE[mode]


def _assert_same(got, want):
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], want[1])
    assert tuple(got[2:]) == tuple(want[2:])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dp,tp", MESHES)
def test_mesh_encode_bit_equal(dp, tp, mode):
    sig, want = _single(mode)
    assert (want[0]["idx"] < 0).any() and (want[0]["idx"] >= 0).any()
    kernels.reset_launch_counts()
    got = compress_audio_sharded(sig, 16000, 2, mesh=_cpu_mesh(dp, tp),
                                 config=_configs(mode)[1])
    assert not any(kernels.LAUNCHES.values())  # CPU cells run the plain versions
    _assert_same(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_encode_matches_jax_sharded(mode):
    """One (dp, tp) per mode against the JAX package's sharded encode on its
    virtual CPU devices (Pallas in interpret mode), under the parity bar."""
    dp, tp = JAX_MESH[mode]
    sig, _ = _single(mode)
    jcfg, cfg = _configs(mode)
    J = jax_sharded(sig, 16000, 2, mesh=jax_make_mesh(dp * tp, dp=dp, tp=tp), config=jcfg)
    T = compress_audio_sharded(sig, 16000, 2, mesh=_cpu_mesh(dp, tp), config=cfg)
    if mode == "topk":
        assert_topk_bar(sig, J, T)
    else:
        _assert_encode_bar(sig, J, T, cfg, 2 * -(-J[2] // 1024))


def test_prep_pads_only_real_meshes():
    """The bank bucket pads to tp * 256 rows and the range bucket to the
    range split times 256 on real meshes; a mesh of one cell is the
    single-device prep."""
    sig, _ = _sig(16000)
    cfg = EncoderConfig(search="coarse")
    one = port_encode._prep_signal(sig, cfg)
    assert port_encode._prep_signal(sig, cfg, 1, 1)[3:] == one[3:]
    lb, db = port_encode._prep_signal(sig, cfg, 4, 2)[3:]
    n = cfg.range_size
    assert db % 512 == 0 and (lb // n) % (8 * 256) == 0
    assert port_encode._range_split_factor(cfg, n, db, 4, 2) == 8
    assert port_encode._range_split_factor(EncoderConfig(search="exact"), n, db, 4, 2) == 4
    assert port_encode._mesh_dims(_cpu_mesh(1, 1)) == (1, 1)
    _assert_same(compress_audio_sharded(sig, 16000, 2, mesh=_cpu_mesh(1, 1), config=cfg),
                 port.compress_audio_arrays(sig, 16000, 2, config=cfg, device="cpu"))


def test_merge_shard_bests_matches_jax():
    """The tie order (larger score, then lower global row, then sym 0)
    against the JAX merge under shard_map over 8 virtual devices, on the
    planted ties of tests/test_sharding.py and on random integer scores
    (many ties)."""
    M = 64
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 3, (8, M)).astype(np.float32)
    scores[rng.random((8, M)) < 0.2] = -np.inf
    idxs = rng.integers(0, 5, (8, M)).astype(np.int32)
    syms = rng.random((8, M)) < 0.5
    for k in range(8):  # tests/test_sharding.py's planted rows
        scores[k, :4] = (k, 7.0, 3.0, -np.inf)
        idxs[k, :4] = (30 + k, 5 + k, 9, 0)
        syms[k, :4] = (False, False, k != 2, False)
    fn = jax.jit(jax.shard_map(
        lambda s, i, y: jax_merge(s[0], i[0], y[0], "tp"),
        mesh=jax_make_mesh(8, dp=1, tp=8), in_specs=(P("tp"),) * 3,
        out_specs=(P(), P(), P()), check_vma=False,
    ))
    want = [np.asarray(x)[0] for x in fn(jnp.asarray(scores)[:, None], jnp.asarray(idxs)[:, None],
                                         jnp.asarray(syms)[:, None])]
    got = [x.numpy() for x in merge_shard_bests(torch.from_numpy(scores),
                                                torch.from_numpy(idxs), torch.from_numpy(syms))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][0], got[1][0]) == (7.0, 37) and (got[0][1], got[1][1]) == (7.0, 5)
    assert (got[1][2], bool(got[2][2])) == (9, False) and got[0][3] == -np.inf


@pytest.mark.parametrize("step,tp", [(1, 2), (1, 4), (2, 4)])
def test_build_bank_row_shard_matches_jax(step, tp):
    """Each shard of build_bank(..., row_offset, d_rows) equals
    build_bank_jax's shard and the full bank's rows; rows at or past the
    global n_domains are zero."""
    rng = np.random.default_rng(step * 10 + tp)
    sig = (rng.standard_normal(6000) * 0.3).astype(np.float32)
    tile, n = 256, 4
    db, n_domains = 1536, (6000 - tile) // step + 1 - 300
    full = build_bank(torch.from_numpy(sig), tile, n, step, db, n_domains)
    dloc = db // tp
    for j in range(tp):
        got = build_bank(torch.from_numpy(sig), tile, n, step, db, n_domains,
                         row_offset=j * dloc, d_rows=dloc).numpy()
        want = np.asarray(build_bank_jax(jnp.asarray(sig), tile, n, step, db, n_domains,
                                         row_offset=j * dloc, d_rows=dloc))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[j * dloc : (j + 1) * dloc].numpy())
        assert not got[np.arange(dloc) + j * dloc >= n_domains].any()


def _tp_scan_merge(r_c, bank, valid, tp):
    """The exact-tp composition at op level, as the mesh encode runs it: K1
    (its plain version) over each row shard, the shard offset added, the
    merge."""
    dloc = bank.shape[0] // tp
    parts = []
    for j in range(tp):
        sl = slice(j * dloc, (j + 1) * dloc)
        b = bank[sl]
        mean = b.mean(1)
        den = ((b - mean[:, None]) ** 2).sum(1)
        w = (den - bank.shape[1] * mean * mean) / (den + 1e-12) ** 2
        score, idx = kernels.search_scan(r_c, b.T.contiguous(), w, valid[sl])
        parts.append((score, idx + j * dloc))
    s = torch.stack([p[0] for p in parts])
    return merge_shard_bests(s, torch.stack([p[1] for p in parts]),
                             torch.zeros_like(s, dtype=torch.bool))


@pytest.mark.parametrize("tp", [2, 4])
def test_exact_tp_merge_and_all_invalid_bank(tp):
    """Shard scans + merge equal the single scan (a bank whose valid rows
    lie in one shard only included); with no valid row anywhere every
    score stays -inf, and the encode emits sentinels for such ranges."""
    rng = np.random.default_rng(tp)
    r = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    r_c = r - r.mean(1, keepdim=True)
    bank = torch.from_numpy(rng.standard_normal((512, 4)).astype(np.float32))
    for valid in (torch.arange(512) < 495, (torch.arange(512) >= 300) & (torch.arange(512) < 380)):
        mean = bank.mean(1)
        den = ((bank - mean[:, None]) ** 2).sum(1)
        w = (den - 4 * mean * mean) / (den + 1e-12) ** 2
        score, idx = kernels.search_scan(r_c, bank.T.contiguous(), w, valid)
        s, i, _ = _tp_scan_merge(r_c, bank, valid, tp)
        np.testing.assert_array_equal(i.numpy(), idx.numpy())
        np.testing.assert_array_equal(s.numpy(), score.numpy())
    s, _, _ = _tp_scan_merge(r_c, bank, torch.zeros(512, dtype=torch.bool), tp)
    assert torch.isinf(s).all() and (s < 0).all()
    codes = port_encode._pack_out(r[None], torch.zeros((1, 64), dtype=torch.int32), s[None],
                                  torch.tensor([64]), torch.tensor([1.0]),
                                  EncoderConfig(fast_mode=False))
    assert (codes == 0xFF).all()


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_stream_over_mesh_bit_equal(objective):
    """Every shard of the stream over (2, 2) and (4, 1) meshes (the damped
    one with its global pass, which runs unsharded): the single-device
    stream's records."""
    sig, sr = _sig(48000)
    kw = dict(objective=objective, shard_samples=16384, halo=4096, device="cpu")
    want = port.compress_audio_streaming(sig, sr, 2, **kw)
    for dp, tp in ((2, 2), (4, 1)):
        got = port.compress_audio_streaming(sig, sr, 2, mesh=_cpu_mesh(dp, tp), **kw)
        assert got[0].tobytes() == want[0].tobytes() and tuple(got[2:]) == tuple(want[2:])


def test_packed_over_four_cells():
    """A stack of 5 files (two buckets) over a (2, 2) mesh: whole files per
    cell, every file's records its single encode's."""
    sigs = [_sig(n, seed=s)[0] for n, s in ((9000, 1), (9000, 2), (8800, 3), (9100, 4),
                                            (4000, 5))]
    got = port.compress_audio_packed(sigs, 16000, 2, objective="damped",
                                     mesh=_cpu_mesh(2, 2))
    for s, g in zip(sigs, got):
        _assert_same(g, port.compress_audio_arrays(s, 16000, 2, objective="damped",
                                                   device="cpu"))


def test_damped_decode_over_dp4_matches_jax():
    """The damped loop over dp 4: each slab as it decodes alone, within
    float tolerance of the JAX package's sharded decode, and each slab's
    iteration count that of the JAX shard (its _decode_core_sharded)."""
    sig, (rec, bank, n_ranges, n, *_) = _single("damped")
    kw = dict(s_damping=0.25, iterations=8, convergence_eps=1e-3)
    stats = {}
    got = port.decompress_audio(rec, bank, n_ranges, n, mesh=_cpu_mesh(4, 1), stats=stats, **kw)
    jmesh = jax_make_mesh(4, dp=4, tp=1)
    want = jax_decode_mod.decompress_audio(rec, bank, n_ranges, n, mesh=jmesh, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    mb = pad_to(bucket(n_ranges, 256), 4 * 256)
    mloc = mb // 4
    its = []
    for a in range(0, n_ranges, mloc):
        st = {}
        r = rec[a : a + mloc]
        slab = port.decompress_audio(r, bank, len(r), n, device="cpu", stats=st, **kw)
        np.testing.assert_array_equal(got[a * n : (a + len(r)) * n], slab)
        its.append(st["iterations"])
    db = bucket(len(bank), 256)
    bank_t = np.zeros((n, db), np.float32)
    bank_t[:, : len(bank)] = bank.T
    col = {f: np.zeros(mb, t) for f, t in (("s", np.float32), ("o", np.float32),
                                          ("sym", np.uint8))}
    idx = np.full(mb, -1, np.int32)
    idx[:n_ranges] = rec["idx"]
    for f in col:
        col[f][:n_ranges] = rec[f]
    core = jax_decode_mod._decode_core_sharded(jmesh, mb, db, n, 8, 16.0, 0.25)
    _, j_its, _ = core(jnp.asarray(idx), jnp.asarray(col["s"]), jnp.asarray(col["o"]),
                       jnp.asarray(col["sym"]), jnp.asarray(bank_t), jnp.float32(1e-3))
    assert its == np.asarray(j_its)[: len(its)].tolist()
    assert stats["iterations"] == max(its)


def test_make_mesh_and_fetch_global():
    """make_mesh's shapes and its JAX error on missing devices; a mesh from
    an explicit array that repeats a device; fetch_global's row order."""
    m = make_mesh(8, tp=2, device="cpu")
    assert m.shape == {"dp": 4, "tp": 2} and m.size == 8 and m.local_rows() == [0, 1, 2, 3]
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="dp \\* tp"):
        make_mesh(6, dp=4, tp=2, device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="requested 2 devices but only"):
            make_mesh(2)
    assert Mesh(["cpu", "cpu"]).shape == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError, match="spans processes"):
        Mesh([["cpu", "cpu"]], owners=[[0, 1]]).local_rows()
    parts = {1: torch.ones(2, 3), 0: np.zeros((1, 3))}
    np.testing.assert_array_equal(fetch_global(parts), np.array([[0] * 3, [1] * 3, [1] * 3]))


_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
proc, port_no = int(sys.argv[1]), sys.argv[2]
from fwav_tpu_torch import compress_audio_arrays, compress_audio_packed, decompress_audio
from fwav_tpu_torch.parallel import Mesh, compress_audio_sharded, init_distributed, make_mesh
mesh = init_distributed("localhost:" + port_no, 2, proc, device="cpu", local_devices=4)
assert mesh.size == 8 and sorted(mesh.local_cells()) == list(range(4 * proc, 4 * proc + 4))
mesh = make_mesh(8, dp=4, tp=2)
assert mesh.local_rows() == [2 * proc, 2 * proc + 1]
rng = np.random.default_rng(7)
t = np.arange(16000 * 2) / 16000.0
sig = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 990 * t)
       + 0.01 * rng.standard_normal(len(t)))
sig[4000:5600] = 0.0
sig = np.round(sig * 16000).astype(np.float32)
for kw in (dict(tile_size=256), dict(search="coarse"), dict(search="exact", tile_size=256)):
    rec, bank, *rest = compress_audio_sharded(sig, 16000, 2, mesh=mesh, **kw)
    rec1, bank1, *rest1 = compress_audio_arrays(sig, 16000, 2, device="cpu", **kw)
    assert rec.tobytes() == rec1.tobytes() and np.array_equal(bank, bank1), kw
    assert rest == rest1 and (rec["idx"] >= 0).any() and (rec["idx"] < 0).any()
sigs = [sig, sig[:-900], sig[:-1700]]
for a, b in zip(compress_audio_packed(sigs, 16000, 2, mesh=mesh),
                compress_audio_packed(sigs, 16000, 2, device="cpu")):
    assert a[0].tobytes() == b[0].tobytes()
rec, bank, n_ranges, n, *_ = compress_audio_arrays(sig, 16000, 2, device="cpu")
st, st1 = {}, {}
got = decompress_audio(rec, bank, n_ranges, n, s_damping=0.25, mesh=make_mesh(8, dp=8),
                       stats=st)
# the same 8 slabs, all in this process
want = decompress_audio(rec, bank, n_ranges, n, s_damping=0.25, mesh=Mesh([["cpu"]] * 8),
                        stats=st1)
assert got.shape == (n_ranges * n,) and np.isfinite(got).all()
assert got.tobytes() == want.tobytes() and st == st1, (st, st1)
print(f"DIST_OK p{proc} n={len(rec)}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_loopback(tmp_path):
    """init_distributed over localhost with gloo: 2 processes x 4 CPU
    cells, the global (4, 2) mesh; the sharded encode, the packed stack and
    the damped decode run across the processes, each running its own rows;
    in both the records equal the single-device encode's and the decode
    equals, byte for byte, the same eight slabs decoded in one process."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port_no = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port_no],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"DIST_OK p{i}" in out, out[-4000:]
