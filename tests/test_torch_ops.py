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


# --- stacks of files: the core's torch ops along the last axis --------------


def _stack_signals(B, nb, seed=0):
    """B signals of differing true lengths in one (B, nb) zero-padded
    buffer, some with a silent gap."""
    rng = np.random.default_rng(seed)
    lens = [nb - 43 - 97 * b for b in range(B)]
    buf = np.zeros((B, nb), np.float32)
    for b, n in enumerate(lens):
        t = np.arange(n) / 8000
        x = 0.3 * np.sin(2 * np.pi * (200 + 30 * b) * t) + 0.01 * rng.standard_normal(n)
        x[n // 3 : n // 3 + 200 * (b % 3)] = 0.0
        buf[b, :n] = x
    return buf, lens


@pytest.mark.parametrize("B,frame", [(1, 8), (3, 8), (16, 8), (3, 12)])
def test_voiced_mask_stack_equals_per_file(B, frame):
    """Per-file frame validity, tail frame and cut (frame 12 does not
    divide the buffer: the gathered-frames branch)."""
    buf, lens = _stack_signals(B, 4096)
    got = vad.voiced_mask(torch.from_numpy(buf), torch.tensor(lens), frame, 1e-4)
    assert got.shape == (B, 4096) and got.dtype == torch.uint8
    for b in range(B):
        want = vad.voiced_mask(torch.from_numpy(buf[b]), lens[b], frame, 1e-4)
        assert torch.equal(got[b], want)
        np.testing.assert_array_equal(
            want.numpy()[: lens[b]], vad.voiced_detection(buf[b, : lens[b]], frame, 1e-4))
        assert 0 < int(want.sum()) and not want[lens[b]:].any()


@pytest.mark.parametrize("B", [1, 3, 16])
def test_bank_ops_stack_equals_per_file(B):
    from fwav_tpu_torch.models.encode import _means_setup as means_setup

    buf, lens = _stack_signals(B, 8192, seed=1)
    x = torch.from_numpy(buf)
    for width in (1, 7, 32):
        sums = domains.box_sums(x, width)
        for b in range(B):  # the tail wraps within the file's own row
            assert torch.equal(sums[b], domains.box_sums(x[b], width))
    n_dom = [domains.n_domains_for(n, 128, 1) for n in lens]
    bank = domains.build_bank(x, 128, 4, 1, 8192, torch.tensor(n_dom))
    ext, sub = means_setup(x, 4, 32, 16, 512)
    assert bank.shape == (B, 8192, 4) and sub.shape == (B, 512, 4)
    for b in range(B):
        assert torch.equal(bank[b], domains.build_bank(x[b], 128, 4, 1, 8192, n_dom[b]))
        ext_b, sub_b = means_setup(x[b], 4, 32, 16, 512)
        assert torch.equal(ext[b], ext_b) and torch.equal(sub[b], sub_b)
        assert not bank[b, n_dom[b]:].any()


@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("tile", [1024, 1500, 4352, 8192])
def test_bank_means_ref_equals_host_build(tile, step):
    """bank_means' plain version on a stack of two int16 files of different
    lengths (so different domain counts; block 300 at tile 1500, no power
    of 2), with full-scale and all-zero runs, gives build_domains_host's
    bits on each file's float32 samples; rows past a file's count stay 0."""
    from fwav_tpu_torch.ops import kernels

    n = max(4, tile // 256)
    rng = np.random.default_rng(tile + step)
    lens = [30000, 21111]
    x = np.zeros((2, 32768), dtype=np.int16)
    for b, L in enumerate(lens):
        x[b, :L] = rng.integers(-32767, 32768, L)
        x[b, 500:2500] = 0
        x[b, 4000:4600] = 32767
        x[b, 7000:7300] = -32767
    n_dom = [domains.n_domains_for(L, tile, step) for L in lens]
    assert n_dom[0] != n_dom[1]
    got = kernels.bank_means(torch.from_numpy(x), n_dom, tile, n, step)
    assert got.shape == (2, kernels.bank_rows(n_dom), n) and got.dtype == torch.float32
    for b, L in enumerate(lens):
        want = domains.build_domains_host(x[b, :L].astype(np.float32), tile, n, step)
        np.testing.assert_array_equal(got[b, : n_dom[b]].numpy().view(np.uint32),
                                      want.view(np.uint32))
        assert not got[b, n_dom[b]:].any()


@pytest.mark.parametrize("stats", ["given", "subsampled"])
@pytest.mark.parametrize("top_c", [1, 4])
@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_coarse_refine_search_matches_jax(objective, top_c, stats):
    """ops/search.py coarse_refine_search against the JAX op on a signal's
    bank (zero rows past its valid prefix, as the encode pads it), with the
    bank's stats or (d_mean None) the subsampled rows': the same idx but at
    near-ties (ops/near_tie.py), the same orientation where the idx agree,
    s, o, err and the score to float tolerance."""
    from fwav_tpu_torch.ops import coarse_refine_search
    from fwav_tpu_torch.ops.near_tie import check_argmax

    sig = bench.make_signal(0.5)
    sig = (sig / np.abs(sig).max()).astype(np.float32)
    n_valid = len(sig) - 1024 + 1
    bank = np.zeros((22528, 4), np.float32)  # 704 subsampled rows at stride 32
    bank[:n_valid] = jax_domains.build_domains_host(sig, 1024, 4, 1)
    valid = np.arange(len(bank)) < n_valid
    ranges = sig[4000:8096].reshape(1024, 4).copy()
    args = (32, top_c, 64, 16.0)
    jm = jd = tm = td = None
    if stats == "given":
        jm, jd = jax_affine.affine_stats(jnp.asarray(bank))
        tm, td = affine.affine_stats(torch.from_numpy(bank))
    want = jax_search.coarse_refine_search(
        jnp.asarray(ranges), jnp.asarray(bank), jm, jd, jnp.asarray(valid), *args,
        objective=objective, return_score=True)
    got = coarse_refine_search(torch.from_numpy(ranges), torch.from_numpy(bank), tm, td,
                               torch.from_numpy(valid), *args, objective=objective,
                               return_score=True)
    assert len(got) == 6 and len(coarse_refine_search(
        torch.from_numpy(ranges), torch.from_numpy(bank), tm, td, torch.from_numpy(valid),
        *args, objective=objective)) == 5
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert got[0].dtype == np.int32 and got[3].dtype == np.uint8
    check_argmax("coarse_refine_search", (got[5], got[0]), (want[5], want[0]))
    same = got[0] == want[0]
    assert same.mean() > 0.99 and (got[0] < n_valid).all()
    np.testing.assert_array_equal(got[3][same], want[3][same])
    for k in (1, 2, 4):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5, atol=1e-6)
