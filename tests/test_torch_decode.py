"""The port's decode against fwav_tpu.models.decode.decompress_audio on the
same records, on the CPU: the iterative loop (s_damping != 0, or no
iteration at all) and the s_damping=0 closed form, with -1 sentinel rows,
degenerate (flat) tiles, scales past the clip and mirrored tiles.

Bar: the reconstructions agree to atol 1e-5 on unit-scale samples (the
loop's per-range sums and the norms of its stop test run in float32 in
each package's own order), and the convergence counters agree: the same
iteration count and converged flag, final delta to rtol 1e-4 or atol 1e-7
(near convergence the relative delta is the norm of a few float32 ulps
per sample, so its low digits are rounding). The closed form is
bit-equal."""

import numpy as np
import pytest
import torch

import fwav_tpu.models.decode as jax_decode_mod
import fwav_tpu_torch as port
from fwav_tpu.models.decode import decompress_audio as jax_decode
from fwav_tpu_torch.config import DecoderConfig
from fwav_tpu_torch.models import decode as port_decode_mod

torch.set_num_threads(2)


def _fixture(seed=0, M=64, N=4, D=48):
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((D, N)).astype(np.float32)
    bank[5] = 3.14  # flat tiles: no centered energy, the stored s applies
    bank[11] = 0.0
    rec = np.zeros(M, dtype=port.MATCH_DTYPE)
    rec["idx"] = rng.integers(0, D, M)
    rec["idx"][::7] = -1
    rec["idx"][3], rec["idx"][4] = 5, 11
    rec["s"] = rng.uniform(-30, 30, M)  # past the +/-16 clip
    rec["o"] = rng.standard_normal(M)
    rec["sym"] = rng.integers(0, 2, M)
    rec["err"] = np.abs(rng.standard_normal(M))
    return rec, bank


def _both(rec, bank, N, **kw):
    out = {}
    for name, fn, extra in (("jax", jax_decode, {}), ("port", port.decompress_audio,
                                                      {"device": "cpu"})):
        stats = {}
        out[name] = fn(rec, bank, len(rec), N, stats=stats, **kw, **extra), stats
    return out["jax"], out["port"]


def _assert_same(j, t, exact=False):
    (out_j, st_j), (out_t, st_t) = j, t
    assert out_t.dtype == np.float32 and out_t.shape == out_j.shape
    if exact:
        np.testing.assert_array_equal(out_t, out_j)
    else:
        np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=0)
    assert st_t["iterations"] == st_j["iterations"], (st_t, st_j)
    assert st_t["converged"] == st_j["converged"]
    if np.isfinite(st_j["final_delta"]):
        np.testing.assert_allclose(st_t["final_delta"], st_j["final_delta"], rtol=1e-4,
                                   atol=1e-7)
    else:
        assert st_t["final_delta"] == st_j["final_delta"]


@pytest.mark.parametrize("s_damping", [0.0, 0.25, 0.9, -0.5])
@pytest.mark.parametrize("iterations", [0, 1, 8])
def test_decode_matches_jax(s_damping, iterations):
    rec, bank = _fixture()
    j, t = _both(rec, bank, 4, iterations=iterations, s_damping=s_damping)
    _assert_same(j, t, exact=s_damping == 0 and iterations >= 1)


@pytest.mark.parametrize("eps", [0.0, 1e-3, 1e-6])
def test_decode_loop_stop_rule_matches_jax(eps):
    """eps 0 runs to the cap; the others stop on the float32 delta."""
    rec, bank = _fixture(1, M=300, N=5, D=120)
    j, t = _both(rec, bank, 5, iterations=60, s_damping=0.4, convergence_eps=eps,
                 original_len=300 * 5 - 3)
    _assert_same(j, t)
    if eps == 0:
        assert t[1]["iterations"] == 60 and not t[1]["converged"]
    else:
        assert t[1]["iterations"] < 60 and t[1]["converged"]


def test_chunked_decode_matches_jax(monkeypatch):
    """Chunks of DECODE_SHARD_RANGES ranges in both packages: the report is
    the worst chunk's."""
    monkeypatch.setattr(jax_decode_mod, "DECODE_SHARD_RANGES", 16)
    monkeypatch.setattr(port_decode_mod, "DECODE_SHARD_RANGES", 16)
    rec, bank = _fixture(2, M=50)
    for kw in (dict(iterations=6, s_damping=0.3), dict(iterations=8)):
        j, t = _both(rec, bank, 4, **kw)
        _assert_same(j, t, exact="s_damping" not in kw)


def test_decode_edge_tables_match_jax():
    """All sentinels, a stored idx past the bank (clamped to its last row),
    and a config object."""
    rec, bank = _fixture(3, M=40)
    silent = rec.copy()
    silent["idx"] = -1
    _assert_same(*_both(silent, bank, 4, s_damping=0.25))
    past = rec.copy()
    past["idx"][[1, 2]] = len(bank) + 5
    _assert_same(*_both(past, bank, 4, s_damping=0.25))
    cfg = DecoderConfig(iterations=3, s_damping=0.4)
    t = port.decompress_audio(rec, bank, len(rec), 4, config=cfg, device="cpu")
    np.testing.assert_array_equal(
        t, port.decompress_audio(rec, bank, len(rec), 4, iterations=3, s_damping=0.4,
                                 device="cpu"))


def test_damped_loop_reaches_the_stored_transform():
    """With 0 < s_damping < 1 the refit converges to the stored transform
    clip(s) d + o, as in the JAX package's semantics test."""
    rng = np.random.default_rng(1)
    D, N, M = 16, 8, 16
    bank = rng.standard_normal((D, N)).astype(np.float32)
    rec = np.zeros(M, dtype=port.MATCH_DTYPE)
    rec["idx"] = rng.integers(0, D, M)
    rec["s"] = rng.uniform(-2, 2, M)
    rec["o"] = rng.uniform(-1, 1, M)
    got = port.decompress_audio(rec, bank, M, N, iterations=200, convergence_eps=1e-12,
                                s_damping=0.5, device="cpu")
    want = (rec["s"][:, None] * bank[rec["idx"]] + rec["o"][:, None]).reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-3)
