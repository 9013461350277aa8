"""The port's ops against their JAX counterparts on the CPU: the same
numpy inputs go through both. The device VAD mask and the box-mean bank
must be bit-equal; the per-domain statistics agree to rtol 1e-6 (their
row sums may be taken in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_sharded import _sig

import bench
from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
from fwav_tpu.models.encode import _means_setup as jax_means_setup
from fwav_tpu.ops import affine as jax_affine
from fwav_tpu.ops import domains as jax_domains
from fwav_tpu.ops import search as jax_search
from fwav_tpu.ops import vad as jax_vad
from fwav_tpu_torch.config import EncoderConfig
from fwav_tpu_torch.models.encode import _means_setup
from fwav_tpu_torch.ops import affine, domains, search, vad
from fwav_tpu_torch.utils.buckets import bucket

torch.set_num_threads(2)


def _signal(request, name):
    if name in ("tone", "speechlike"):
        return request.getfixturevalue(name)[0]
    if name == "sig66000":
        return _sig(66000)[0]
    return bench.make_signal(2.0)


def _padded(sig):
    out = np.zeros(bucket(len(sig), 4096), np.float32)
    out[: len(sig)] = sig
    return out


@pytest.mark.parametrize("scale", ["raw", "quiet"])
@pytest.mark.parametrize("name", ["tone", "speechlike", "sig66000", "bench2s"])
def test_voiced_mask_bit_equal(request, name, scale):
    """The device VAD at frame_size 8 (range_size 4), on the raw int16-scale
    signal the encode core sees and on a quiet copy (peak 0.015) whose
    frame energies cross the 1e-4 and 5e-5 thresholds."""
    sig = _signal(request, name)
    if scale == "quiet":
        sig = (sig * (0.015 / np.abs(sig).max())).astype(np.float32)
    padded = _padded(sig)
    want = np.asarray(jax_vad.voiced_mask_jax(jnp.asarray(padded), len(sig), 8, 1e-4))
    got = vad.voiced_mask(torch.from_numpy(padded), len(sig), 8, 1e-4).numpy()
    np.testing.assert_array_equal(got, want)
    host = vad.voiced_detection(sig, frame_size=8, energy_threshold=1e-4)
    np.testing.assert_array_equal(
        host, jax_vad.voiced_detection(sig, frame_size=8, energy_threshold=1e-4)
    )
    if scale == "quiet":
        assert 0 < got[: len(sig)].sum() < len(sig)  # both states occur


def test_voiced_mask_gather_framing_bit_equal():
    """A frame size that does not divide the padded length (range_size 6)
    takes the gather-framed branch."""
    sig = _sig(20001)[0]
    sig = (sig / np.abs(sig).max()).astype(np.float32)
    padded = _padded(sig)
    want = np.asarray(jax_vad.voiced_mask_jax(jnp.asarray(padded), len(sig), 12, 1e-4))
    got = vad.voiced_mask(torch.from_numpy(padded), len(sig), 12, 1e-4).numpy()
    np.testing.assert_array_equal(got, want)


def test_hysteresis_bit_equal():
    rng = np.random.default_rng(0)
    e = rng.uniform(0, 2e-4, 4096).astype(np.float32)
    e[::97] = np.float32(1e-4)   # exactly on the on-threshold
    e[::89] = np.float32(5e-5)   # exactly on the off-threshold
    want = np.asarray(jax_vad.hysteresis_jax(jnp.asarray(e), 1e-4, 5e-5))
    got = vad.hysteresis(torch.from_numpy(e), 1e-4, 5e-5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vad.hysteresis_np(e, 1e-4, 5e-5))


@pytest.mark.parametrize("width", [1, 7, 64, 256, 300])
def test_box_sums_bit_equal(width):
    x = (np.random.default_rng(width).standard_normal(8192) * 0.3).astype(np.float32)
    want = np.asarray(jax_domains.box_sums(jnp.asarray(x), width))
    np.testing.assert_array_equal(domains.box_sums(torch.from_numpy(x), width).numpy(), want)


@pytest.mark.parametrize("tile_size,n_samples", [(1024, 16000), (128, 960), (2048, 9000)])
def test_build_bank_bit_equal(tile_size, n_samples):
    cfg = EncoderConfig(tile_size=tile_size)
    n, step = cfg.range_size, cfg.domain_step
    sig = _sig(n_samples)[0]
    sig = (sig / np.abs(sig).max()).astype(np.float32)
    padded = _padded(sig)
    n_domains = domains.n_domains_for(n_samples, tile_size, step)
    db = bucket(n_domains, 256)
    want = np.asarray(jax_domains.build_bank_jax(
        jnp.asarray(padded), tile_size, n, step, db, n_domains
    ))
    got = domains.build_bank(torch.from_numpy(padded), tile_size, n, step, db, n_domains)
    np.testing.assert_array_equal(got.numpy(), want)
    host = domains.build_domains_host(sig, tile_size, n, step)
    np.testing.assert_array_equal(host, jax_domains.build_domains_host(sig, tile_size, n, step))
    # float32 box sums vs the host's float64 cumulative sums
    np.testing.assert_allclose(got.numpy()[:n_domains], host, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seconds,dc", [(10.0, 3584), (1.5, 512)])
def test_means_setup_bit_equal(seconds, dc):
    """The coarse path's box-mean layouts at the 10 s bench geometry (3,584
    subsampled rows) and at a short file's."""
    sig = bench.make_signal(seconds)
    sig = (sig / np.abs(sig).max()).astype(np.float32)
    padded = _padded(sig)
    ext_j, sub_j = jax_means_setup(jnp.asarray(padded), 4, 256, 128, dc)
    ext_t, sub_t = _means_setup(torch.from_numpy(padded), 4, 256, 128, dc)
    np.testing.assert_array_equal(ext_t.numpy(), np.asarray(ext_j)[0])
    np.testing.assert_array_equal(sub_t.numpy(), np.asarray(sub_j))


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_affine_stats_weights_thresh(objective):
    rng = np.random.default_rng(1)
    tiles = (rng.standard_normal((4096, 4)) * 0.2).astype(np.float32)
    tiles[::13] = tiles[::13, :1]  # flat tiles: zero centered energy
    m_j, d_j = jax_affine.affine_stats(jnp.asarray(tiles))
    m_t, d_t = affine.affine_stats(torch.from_numpy(tiles))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-12)
    # the same statistics into both weight functions
    w_j = jax_search.domain_weights(m_j, d_j, 4, objective)
    w_t = search.domain_weights(torch.tensor(np.asarray(m_j)),
                                torch.tensor(np.asarray(d_j)), 4, objective)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    t_j = jax_search.domain_thresh(d_j, objective, 16.0)
    t_t = search.domain_thresh(torch.tensor(np.asarray(d_j)), objective, 16.0)
    if objective == "damped":
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6)
    else:
        assert t_t is None and t_j is None
    # the gain the kernels fold, on the same raw dot products
    num = (rng.standard_normal(4096) * 3).astype(np.float32)
    g_j = jax_search._gain_from_num(jnp.asarray(num), w_j, t_j, 16.0)
    g_t = search._gain_from_num(torch.from_numpy(num), torch.tensor(np.asarray(w_j)),
                                None if t_j is None else torch.tensor(np.asarray(t_j)), 16.0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6)
    if objective == "damped":
        assert (np.abs(num) > np.asarray(t_j)).any()  # the clip branch fires


def test_encoder_config_from_reference():
    ref = JaxEncoderConfig(tile_size=2048, search="coarse", objective="damped",
                           coarse_topc=2, use_pallas=True, h2d_chunks=4)
    d = dataclasses.asdict(ref)
    cfg = EncoderConfig.from_reference(d)
    got = dataclasses.asdict(cfg)
    assert set(d) - set(got) == {"use_pallas", "h2d_chunks"}
    assert {k: d[k] for k in got} == got
    assert (cfg.range_size, cfg.domain_step) == (ref.range_size, ref.domain_step)
    with pytest.raises(ValueError, match="unknown"):
        EncoderConfig.from_reference({**d, "not_a_field": 1})
