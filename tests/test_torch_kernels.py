"""The plain versions of the port's search kernels (ops/kernels.py, what a
CPU tensor runs) against the JAX package's Pallas kernels in interpret
mode and its lax.scan oracles, on the same seeded inputs.

The bar is tests/test_pallas_search.py's: the set of ranges without a
finite score (-inf) is identical, and the selected idx differ in at most 2
rows per 1,024, only where the two picks' gains, recomputed in float64,
agree to rtol 1e-5 (float32 near-ties: the kernels sum in their own
order). For K3 the same bar holds per row of top-C lists: the lists are
equal in the same order (-1 entries included) except in at most 2 rows
per 1,024, whose entries' float64 gains agree to rtol 1e-5, position by
position. The kernel-vs-plain comparisons that need a card are in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fwav_tpu.ops.affine import affine_stats as jax_affine_stats
from fwav_tpu.ops.pallas_search import (
    exact_search_scan_pallas,
    refine_window_pallas,
    topc_search_scan_pallas,
)
from fwav_tpu.ops.search import (
    domain_thresh,
    domain_weights,
    exact_search_scan,
    gain_topk_scan,
)
from fwav_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _k1_gain(r_c, bank, w, thresh, c, idx):
    """float64 orientation-folded gain of domain idx[m] for range m."""
    r = r_c.astype(np.float64)
    b = bank[idx].astype(np.float64)
    wk = w[idx].astype(np.float64)
    gains = []
    for num in ((r * b).sum(1), (r[:, ::-1] * b).sum(1)):
        g = num * num * wk
        if thresh is not None:
            t = thresh[idx].astype(np.float64)
            g = np.where(np.abs(num) > t, c * (2 * np.abs(num) - t), g)
        gains.append(g)
    return np.maximum(*gains)


def _assert_near_ties(score_a, idx_a, score_b, idx_b, gain_fn):
    fin = np.isfinite(score_a)
    np.testing.assert_array_equal(fin, np.isfinite(score_b))
    diff = np.nonzero(fin & (idx_a != idx_b))[0]
    assert len(diff) <= 2 * -(-len(idx_a) // 1024), len(diff)
    if len(diff):
        np.testing.assert_allclose(gain_fn(idx_a[diff], diff),
                                   gain_fn(idx_b[diff], diff), rtol=1e-5)
    return len(diff)


def _k1_inputs(seed, objective, M=1024, D=2048, N=4):
    rng = np.random.default_rng(seed)
    s_clip = 2.0  # low, so the damped clip branch fires
    r = (rng.standard_normal((M, N)) * 0.5).astype(np.float32)
    bank = (rng.standard_normal((D, N)) * 0.1).astype(np.float32)
    bank[::41] = bank[::41, :1]  # flat rows: negative balanced weights
    r_c = r - r.mean(1, keepdims=True)
    valid = np.ones(D, bool)
    valid[-37:] = False
    dm, dd = jax_affine_stats(jnp.asarray(bank))
    w = np.array(domain_weights(dm, dd, N, objective))
    t = domain_thresh(dd, objective, s_clip)
    t = None if t is None else np.array(t)
    return r_c, bank, w, valid, t, s_clip, dm, dd


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_scan_ref_matches_pallas_and_scan(objective, seed):
    r_c, bank, w, valid, t, s_clip, dm, dd = _k1_inputs(seed, objective)
    score, idx = (x.numpy() for x in kernels.search_scan(
        torch.from_numpy(r_c), torch.from_numpy(bank.T.copy()),
        torch.from_numpy(w), torch.from_numpy(valid),
        None if t is None else torch.from_numpy(t), s_clip,
    ))
    assert kernels.LAUNCHES == {"search_scan": 0, "topc_scan": 0, "refine_window": 0}

    def gain(ix, rows):
        return _k1_gain(r_c[rows], bank, w, t, s_clip, ix)

    s_p, i_p, _ = exact_search_scan_pallas(
        jnp.asarray(r_c), jnp.asarray(bank.T.copy()), jnp.asarray(w),
        jnp.asarray(valid), range_block=128, domain_block=256, interpret=True,
        with_sym=False, d_thresh=None if t is None else jnp.asarray(t),
        s_clip=s_clip,
    )
    _assert_near_ties(score, idx, np.asarray(s_p), np.asarray(i_p), gain)
    s_s, i_s, _ = exact_search_scan(
        jnp.asarray(r_c), jnp.asarray(bank), dm, dd, jnp.asarray(valid), 256,
        objective, s_clip=s_clip,
    )
    _assert_near_ties(score, idx, np.asarray(s_s), np.asarray(i_s), gain)
    np.testing.assert_allclose(score, np.asarray(s_s), rtol=1e-5)
    if objective == "damped":  # the linear branch was exercised
        num = np.abs(r_c @ bank.T)
        assert (num > t[None, :]).any()


def test_search_scan_ref_all_invalid():
    r_c, bank, w, valid, t, s_clip, *_ = _k1_inputs(2, "balanced", M=300, D=700)
    score, idx = kernels.search_scan_ref(
        torch.from_numpy(r_c), torch.from_numpy(bank.T.copy()),
        torch.from_numpy(w), torch.zeros(700, dtype=torch.bool),
    )
    assert np.all(np.isneginf(score.numpy())) and not idx.numpy().any()


def test_search_scan_ref_blocking_is_invisible():
    """Block sizes change nothing: the same lowest-index rule across and
    inside blocks, on a bank with exact ties (duplicated rows)."""
    r_c, bank, w, valid, t, s_clip, *_ = _k1_inputs(3, "balanced", M=500, D=900)
    bank[450:900] = bank[0:450]
    w[450:900] = w[0:450]
    args = (torch.from_numpy(r_c), torch.from_numpy(bank.T.copy()),
            torch.from_numpy(w), torch.from_numpy(valid))
    s1, i1 = kernels.search_scan_ref(*args)
    s2, i2 = kernels.search_scan_ref(*args, range_block=77, domain_block=128)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert int(i1.max()) < 450  # ties resolved to the lower copy


def _k3_gain(r_c, bank, w, thresh, c, idx):
    """float64 K3 score of domain idx[i, k] for range i; -inf where -1."""
    r = r_c.astype(np.float64)[:, None, :]
    safe = np.maximum(idx, 0)
    b = bank[safe].astype(np.float64)
    wk = w[safe].astype(np.float64)
    no, nm = np.abs((r * b).sum(-1)), np.abs((r[..., ::-1] * b).sum(-1))
    if thresh is None:
        g = np.maximum(no * no * wk, nm * nm * wk)
    else:
        a = np.maximum(no, nm)
        t = thresh[safe].astype(np.float64)
        g = np.where(a > t, c * (2 * a - t), a * a * wk)
    return np.where(idx >= 0, g, -np.inf)


def _assert_same_lists(got, want, gain_fn):
    """K3's bar (module docstring); returns the count of differing rows."""
    rows = np.nonzero((got != want).any(1))[0]
    assert len(rows) <= 2 * -(-len(got) // 1024), len(rows)
    np.testing.assert_array_equal(got[rows] < 0, want[rows] < 0)
    if len(rows):
        np.testing.assert_allclose(gain_fn(got[rows], rows), gain_fn(want[rows], rows),
                                   rtol=1e-5)
    return len(rows)


def _k3_case(seed, objective, C, valid_case):
    r_c, bank, w, valid, t, s_clip, dm, dd = _k1_inputs(seed, objective)
    D = len(bank)
    if valid_case == "ties":
        # duplicated rows: every score occurs twice; the lower copy first
        bank[D // 2 :] = bank[: D // 2]
        w[D // 2 :] = w[: D // 2]
        valid[:] = True
        if t is not None:
            t[D // 2 :] = t[: D // 2]
        dm, dd = jax_affine_stats(jnp.asarray(bank))
    elif valid_case == "three":
        valid[:] = False
        valid[[5, 700, 1500]] = True  # C = 4: the last entry of every row is -1
    elif valid_case == "none":
        valid[:] = False
    return r_c, bank, w, valid, t, s_clip, dm, dd


@pytest.mark.parametrize("valid_case", ["tail", "ties", "three", "none"])
@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_topc_scan_ref_matches_pallas_and_scan(objective, C, valid_case):
    r_c, bank, w, valid, t, s_clip, dm, dd = _k3_case(4, objective, C, valid_case)
    got = kernels.topc_scan(
        torch.from_numpy(r_c), torch.from_numpy(bank.T.copy()), torch.from_numpy(w),
        torch.from_numpy(valid), C, None if t is None else torch.from_numpy(t), s_clip,
    )
    assert got.shape == (len(r_c), C) and got.dtype == torch.int32
    assert all(got[:, k].is_contiguous() for k in range(C))  # K2 takes the columns
    assert kernels.LAUNCHES == {"search_scan": 0, "topc_scan": 0, "refine_window": 0}
    got = got.numpy()

    def gain(ix, rows):
        return _k3_gain(r_c[rows], bank, w, t, s_clip, ix)

    jt = None if t is None else jnp.asarray(t)
    pallas = np.asarray(topc_search_scan_pallas(
        jnp.asarray(r_c), jnp.asarray(bank.T.copy()), jnp.asarray(w), jnp.asarray(valid),
        C, range_block=128, domain_block=256, interpret=True, d_thresh=jt, s_clip=s_clip,
    ))
    scan = np.asarray(gain_topk_scan(
        jnp.asarray(r_c), jnp.asarray(bank), jnp.asarray(w), jnp.asarray(valid), C, 256,
        d_thresh=jt, s_clip=s_clip if t is not None else None,
    ))
    _assert_same_lists(got, scan, gain)
    if valid_case == "ties":
        # the TPU kernel orders exact ties by its domain blocks, unlike its
        # oracle (topc_scan_ref's docstring): the same gain at every
        # position, the same -1 entries, another order of equal scores
        assert (pallas != scan).any() or C == 2  # pairs of copies fill C = 2
        np.testing.assert_array_equal(got < 0, pallas < 0)
        np.testing.assert_allclose(gain(got, np.arange(len(got))),
                                   gain(pallas, np.arange(len(got))), rtol=1e-5)
    else:
        _assert_same_lists(got, pallas, gain)
    # the lists are sorted by gain (to float32 rounding), -1 entries last
    g = gain(got, np.arange(len(got)))
    fin = np.isfinite(g)
    assert (fin[:, :-1] | ~fin[:, 1:]).all()
    both = fin[:, :-1] & fin[:, 1:]
    assert (np.diff(g, axis=1)[both] <= 1e-6 * np.abs(g[:, :-1][both])).all()
    if valid_case == "ties":
        # each score occurs twice, so the top two are a domain and its copy
        np.testing.assert_array_equal(got[:, 1], got[:, 0] + len(bank) // 2)
    elif valid_case == "three":
        assert set(np.unique(got[:, :3])) <= {5, 700, 1500}
        assert (got[:, 3:] == -1).all() and (got[:, :3] >= 0).all()
    elif valid_case == "none":
        assert (got == -1).all()


def test_topc_scan_ref_blocking_is_invisible():
    """Block sizes change nothing: per block C rounds of extraction merged
    with a strict > give the one stable order, on a bank with exact ties."""
    r_c, bank, w, valid, t, s_clip, *_ = _k3_case(5, "damped", 4, "ties")
    args = (torch.from_numpy(r_c), torch.from_numpy(bank.T.copy()),
            torch.from_numpy(w), torch.from_numpy(valid), 4, torch.from_numpy(t), s_clip)
    a = kernels.topc_scan_ref(*args)
    b = kernels.topc_scan_ref(*args, range_block=77, domain_block=96)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="top_c"):
        kernels.topc_scan(*args[:4], 9)


def _k2_inputs(seed, M=1024, dc=40, tail=700):
    rng = np.random.default_rng(seed)
    stride, B, n = 128, 256, 4
    n_valid = dc * stride - tail  # an invalid tail exercises the position mask
    sig = (rng.standard_normal(dc * stride + n * B + 2048) * 0.2).astype(np.float32)
    means = np.convolve(sig, np.ones(B) / B, mode="valid").astype(np.float32)
    W = stride + stride // 4
    lane0 = stride - W // 2
    Lslice = -(-(lane0 + (W - 1) + (n - 1) * B + 1) // 128) * 128
    Lext = -(-(stride + (dc - 1) * stride + Lslice) // 128) * 128
    ext = np.zeros(Lext, np.float32)
    k = min(len(means), Lext - stride)
    ext[stride : stride + k] = means[:k]
    lobes = rng.integers(0, dc, M).astype(np.int32)
    lobes[::17] = -1  # ranges without a lobe
    ranges = (rng.standard_normal((M, n)) * 1.5).astype(np.float32)
    return ext, means, lobes, ranges, n_valid, stride, B


def _k2_gain(means, ranges, rows, pos, B, objective, c):
    """float64 window gain of position pos[i] for range rows[i]."""
    out = []
    for m, p in zip(rows, pos):
        rc = ranges[m].astype(np.float64)
        rc = rc - rc.mean()
        v = np.array([means[p + j * B] for j in range(len(rc))], np.float64)
        den = ((v - v.mean()) ** 2).sum()
        a = max(abs((rc * v).sum()), abs((rc[::-1] * v).sum()))
        if objective == "balanced":
            g = a * a * (den - len(rc) * v.mean() ** 2) / max(den, 1e-12) ** 2
        elif objective == "damped" and a > c * den:
            g = c * (2 * a - c * den)
        else:
            g = a * a / max(den, 1e-12)
        out.append(g)
    return np.array(out)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_refine_window_ref_matches_pallas(objective):
    ext, means, lobes, ranges, n_valid, stride, B = _k2_inputs(0)
    c = 2.0
    score, idx = (x.numpy() for x in kernels.refine_window(
        torch.from_numpy(ext), torch.from_numpy(lobes), torch.from_numpy(ranges),
        n_valid, stride, B, objective, c,
    ))
    assert kernels.LAUNCHES == {"search_scan": 0, "topc_scan": 0, "refine_window": 0}
    s_p, i_p = refine_window_pallas(
        jnp.asarray(ext).reshape(1, -1), jnp.asarray(lobes), jnp.asarray(ranges),
        n_valid, stride, B, objective, 256, interpret=True, s_clip=c,
    )
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    assert np.all(np.isneginf(score[lobes < 0])) and not idx[lobes < 0].any()
    _assert_near_ties(
        score, idx, s_p, i_p,
        lambda ix, rows: _k2_gain(means, ranges, rows, ix, B, objective, c),
    )
    fin = np.isfinite(score)
    np.testing.assert_allclose(score[fin], s_p[fin], rtol=1e-4)
    assert (idx < n_valid).all() and (idx >= 0).all()
    if objective == "damped":  # the linear branch won somewhere
        rows = np.nonzero(fin)[0]
        lin = _k2_gain(means, ranges, rows, idx[rows], B, "damped", c)
        quad = _k2_gain(means, ranges, rows, idx[rows], B, "affine", c)
        assert (lin != quad).any()


def test_refine_window_ref_masked_window():
    """A lobe whose whole window lies past n_valid scores -inf and clips
    its idx into [0, n_valid - 1], as the TPU kernel does."""
    ext, means, lobes, ranges, n_valid, stride, B = _k2_inputs(1, M=64, dc=24, tail=2000)
    lobes[:] = 23  # window starts past n_valid
    score, idx = kernels.refine_window_ref(
        torch.from_numpy(ext), torch.from_numpy(lobes), torch.from_numpy(ranges),
        n_valid, stride, B,
    )
    s_p, i_p = refine_window_pallas(
        jnp.asarray(ext).reshape(1, -1), jnp.asarray(lobes), jnp.asarray(ranges),
        n_valid, stride, B, "balanced", 64, interpret=True,
    )
    assert np.all(np.isneginf(score.numpy())) and np.all(np.isneginf(np.asarray(s_p)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_p))


def test_blocks_gates_match_jax():
    from fwav_tpu.ops.pallas_search import pallas_blocks_ok, refine_blocks_ok

    for args in [(512, 160, 512, 32), (512, 160, 512, 160), (8192, 20480, 512, 2048),
                 (512, 320, 512, 64), (4, 2048, 4, 2048)]:
        assert kernels.pallas_blocks_ok(*args) == pallas_blocks_ok(*args)
    for args in [(16384, 512, 128, 1, "balanced", 458752), (16384, 512, 64, 1, "balanced", 0),
                 (16384, 512, 128, 2, "affine", 0), (16384, 512, 128, 1, "damped", 3 << 20),
                 (16384, 512, 128, 1, "topk", 0)]:
        M, rb, stride, step, obj, db = args
        assert kernels.refine_blocks_ok(*args) == refine_blocks_ok(M, rb, stride, step, 1, obj, db)
