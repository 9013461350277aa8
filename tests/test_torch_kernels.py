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
position. The bar is fwav_tpu_torch/ops/near_tie.py's, which also holds
the CUDA kernels to these plain versions on the card
(tests/test_torch_cuda.py); its comparators are tested here."""

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
from fwav_tpu_torch.ops import kernels, near_tie
from fwav_tpu_torch.ops.affine import row_mean

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
    return near_tie.check_argmax("scan", (score_a, idx_a), (score_b, idx_b),
                                 gain_fn)["idx_diff"]


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
    assert not any(kernels.LAUNCHES.values())

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


def _assert_same_lists(got, want, gain_fn):
    """K3's bar (module docstring); returns the count of differing rows."""
    return near_tie.check_lists("lists", got, want, gain_fn)["idx_diff"]


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
    assert not any(kernels.LAUNCHES.values())
    got = got.numpy()

    def gain(ix, rows):
        return near_tie.topc_gain64(r_c[rows], bank.T, w, t, s_clip, ix)

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
    assert not any(kernels.LAUNCHES.values())
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


def _k2_lobe_matrix(seed, M, dc):
    """(M, 4) lobes with what K3 and the callers can hand K2: windows cut
    by position 0 (lobe 0) and by n_valid (the last lobes), -1 in any slot
    (a whole row too), and a lobe that repeats within its row."""
    rng = np.random.default_rng(seed)
    lobes = rng.integers(0, dc, (M, 4)).astype(np.int32)
    lobes[::5, 0] = 0
    lobes[1::5, 1] = dc - 1
    lobes[2::7, 3] = -1
    lobes[3::11, 1:] = -1
    lobes[4::13] = -1
    lobes[5::9, 2] = lobes[5::9, 0]
    return lobes


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_refine_window_lobe_matrix_matches_pallas_per_lobe(objective):
    """refine_window on an (M, 4) lobe tensor against the JAX callers'
    loop: refine_window_pallas once per lobe column, a later column taking
    a range only with a strictly higher score. Bar: the near-tie bar and
    rtol 1e-4 of test_refine_window_ref_matches_pallas."""
    ext, means, _, ranges, n_valid, stride, B = _k2_inputs(3, M=512)
    lobes = _k2_lobe_matrix(4, 512, 40)
    c = 2.0
    for lob in (torch.from_numpy(lobes), torch.from_numpy(lobes.T.copy()).T):
        score, idx = (x.numpy() for x in kernels.refine_window(
            torch.from_numpy(ext), lob, torch.from_numpy(ranges), n_valid, stride,
            B, objective, c,
        ))
        assert not any(kernels.LAUNCHES.values())
        s_p = i_p = None
        for k in range(4):
            s_k, i_k = (np.asarray(x) for x in refine_window_pallas(
                jnp.asarray(ext).reshape(1, -1), jnp.asarray(lobes[:, k]),
                jnp.asarray(ranges), n_valid, stride, B, objective, 256,
                interpret=True, s_clip=c,
            ))
            if k == 0:
                s_p, i_p = s_k, i_k
            else:
                take = s_k > s_p
                s_p, i_p = np.where(take, s_k, s_p), np.where(take, i_k, i_p)
        dead = (lobes < 0).all(1)
        assert dead.any() and np.all(np.isneginf(score[dead])) and not idx[dead].any()
        _assert_near_ties(
            score, idx, s_p, i_p,
            lambda ix, rows: _k2_gain(means, ranges, rows, ix, B, objective, c),
        )
        fin = np.isfinite(score)
        np.testing.assert_allclose(score[fin], s_p[fin], rtol=1e-4)
        assert (idx < n_valid).all() and (idx >= 0).all()


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_refine_window_one_column_equals_vector(objective):
    ext, _, lobes, ranges, n_valid, stride, B = _k2_inputs(5, M=300)
    args = (torch.from_numpy(ranges), n_valid, stride, B, objective, 2.0)
    s1, i1 = kernels.refine_window(torch.from_numpy(ext), torch.from_numpy(lobes), *args)
    s2, i2 = kernels.refine_window(torch.from_numpy(ext),
                                   torch.from_numpy(lobes)[:, None], *args)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_refine_window_earlier_lobe_wins_exact_ties():
    """A box-mean sequence of period 4 strides: lobes a and a + 4 score the
    same bits, and the one named first gives the position."""
    ext, _, _, ranges, _, stride, B = _k2_inputs(6, M=64)
    period = 4 * stride
    ext = np.tile(ext[stride : stride + period], len(ext) // period + 1)[: len(ext)]
    n_valid = len(ext) - 2 * stride
    a = np.arange(64, dtype=np.int32) % 20 + 2
    for order in ((a, a + 4), (a + 4, a)):
        lobes = np.stack(order, axis=1)
        s, i = kernels.refine_window(torch.from_numpy(ext), torch.from_numpy(lobes),
                                     torch.from_numpy(ranges), n_valid, stride, B)
        both = [kernels.refine_window(torch.from_numpy(ext), torch.from_numpy(col.copy()),
                                      torch.from_numpy(ranges), n_valid, stride, B)
                for col in order]
        assert torch.equal(both[0][0], both[1][0])  # the tie is exact
        assert torch.equal(s, both[0][0]) and torch.equal(i, both[0][1])
        assert not torch.equal(i, both[1][1])


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("n", [4, 7])
def test_window_stats_ref_equals_inline_statistics(objective, n):
    """window_stats_ref holds, bit for bit, what refine_window_ref computes
    inline for each position: scoring a window from the table's entries
    gives refine_window_ref's scores."""
    rng = np.random.default_rng(8)
    stride, B, dc, M = 128, 256, 12, 40
    L = stride + dc * stride + n * B
    ext = np.zeros(L, np.float32)
    ext[stride : L - 300] = rng.standard_normal(L - 300 - stride).astype(np.float32) * 0.2
    ranges = (rng.standard_normal((M, n)) * 1.5).astype(np.float32)
    lobes = rng.integers(0, dc, M).astype(np.int32)
    c, W = 2.0, stride + stride // 4
    te, tr = torch.from_numpy(ext), torch.from_numpy(ranges)
    stats = kernels.window_stats(te, n, B, objective)
    assert stats.shape == (L,)
    rc = tr - row_mean(tr)[:, None]
    q = (torch.from_numpy(lobes).long() * stride - W // 2 + stride)[:, None] + torch.arange(W)
    v = [torch.where(q + j * B < L, te[(q + j * B).clamp(max=L - 1)], 0.0) for j in range(n)]
    no, nm = rc[:, 0:1] * v[0], rc[:, n - 1 : n] * v[0]
    for j in range(1, n):
        no = no + rc[:, j : j + 1] * v[j]
        nm = nm + rc[:, n - 1 - j : n - j] * v[j]
    if objective == "balanced":
        sc = torch.maximum(no * no, nm * nm) * stats[q]
    elif objective == "affine":
        sc = torch.maximum(no * no, nm * nm) / (stats[q] + 1e-12)
    else:
        a = torch.maximum(no.abs(), nm.abs())
        th = c * stats[q]
        sc = torch.where(a > th, c * (2.0 * a - th), a * a / (stats[q] + 1e-12))
    pos = q - stride
    n_valid = dc * stride
    sc = torch.where((pos >= 0) & (pos < n_valid), sc, float("-inf"))
    s_ref, i_ref = kernels.refine_window_ref(te, torch.from_numpy(lobes), tr, n_valid,
                                             stride, B, objective, c)
    assert torch.equal(sc.max(1).values, s_ref)
    assert torch.equal((pos[:, 0] + sc.argmax(1)).clamp(0, n_valid - 1).int(), i_ref)


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


# --- the near-tie comparators (ops/near_tie.py) ---------------------------


def _argmax_case(case):
    """(got, want) argmax results over 2,048 rows: a near-tie flip, a flip
    at a real score gap, a changed -inf set, or too many near-tie flips."""
    rng = np.random.default_rng(8)
    score = rng.uniform(1.0, 2.0, 2048).astype(np.float32)
    idx = rng.integers(0, 500, 2048).astype(np.int32)
    score[7] = -np.inf
    s2, i2 = score.copy(), idx.copy()
    flips = {"near_tie": [3, 900], "gap": [3], "neg_inf": [], "too_many": list(range(10, 15))}
    rows = flips[case]
    i2[rows] += 1
    s2[rows] *= np.float32(1 + 2e-6) if case != "gap" else np.float32(1.01)
    if case == "neg_inf":
        s2[9] = -np.inf
    return (s2, i2), (score, idx)


@pytest.mark.parametrize("case,passes", [("near_tie", True), ("gap", False),
                                         ("neg_inf", False), ("too_many", False)])
def test_near_tie_argmax_bar(case, passes):
    got, want = _argmax_case(case)
    if passes:
        out = near_tie.check_argmax("K1", got, want)
        assert out["idx_diff"] == 2 and out["rows"] == 2048
        assert out["finite"] == 2047 and 0 < out["max_abs_err"] < 1e-4
    else:
        with pytest.raises(AssertionError, match="K1"):
            near_tie.check_argmax("K1", got, want)


def _lists_case(case):
    """(got, want, gain) top-4 lists over 2,048 rows whose float64 gain is
    fixed per domain: two near-tied entries swapped, a clear winner
    dropped, a changed -1 set, or too many rows with swapped near-ties."""
    D = 600
    gains = np.linspace(10.0, 1.0, D)
    gains[[20, 21]] = [5.0, 5.0 * (1 - 3e-6)]  # a near-tie pair
    want = np.tile(np.array([0, 1, 20, 21], np.int32), (2048, 1))
    want[5] = [0, 20, 21, -1]
    got = want.copy()
    rows = {"swap": [1], "drop": [1], "unfilled": [], "too_many": list(range(100, 105))}
    for r in rows[case]:
        got[r] = [0, 1, 21, 20] if case != "drop" else [1, 20, 21, 30]
    if case == "unfilled":
        got[6, 3] = -1

    def gain(idx, _rows):
        return np.where(idx >= 0, gains[np.maximum(idx, 0)], -np.inf)

    return got, want, gain


@pytest.mark.parametrize("case,passes", [("swap", True), ("drop", False),
                                         ("unfilled", False), ("too_many", False)])
def test_near_tie_lists_bar(case, passes):
    got, want, gain = _lists_case(case)
    if passes:
        out = near_tie.check_lists("K3", got, want, gain)
        assert out["idx_diff"] == 1 and out["unfilled"] == 1
        assert 0 < out["max_rel_gap"] < near_tie.NEAR_TIE_RTOL
    else:
        with pytest.raises(AssertionError, match="K3"):
            near_tie.check_lists("K3", got, want, gain)


def test_near_tie_allowance_rounds_up():
    assert [near_tie.allowed_diffs(n) for n in (1, 1024, 1025, 114688)] == [2, 2, 4, 224]
