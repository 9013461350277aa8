"""K4's plain version (ops/kernels.py staged_refine_ref, what a CPU tensor
runs: refine_from_lobes over range blocks and a stack)
against the JAX package's refine_from_lobes on the CPU, on seeded inputs.

Covered: the (16, 4) descent (stride 128 and 512), the (8,) stage (stride
32), the dense window of 2 and 4 lobes and of one lobe at stride 16; lobes
of -1, windows cut at both ends of the valid rows, n_valid under W (and 1
and 0); range sizes 4, 8 and 32. The bar: the -inf sets are equal; idx
differ only at near-ties, under fwav_tpu_torch/ops/near_tie.py's bar (at
most 2 rows per 1,024, whose picks' scores agree to 1e-5); the scores of
equal picks agree to rtol 1e-6 (the two packages may sum in their own
order; on these inputs they hold exactly: no differing idx and no score
error in the 21,600 rows of the cases below). The global pass's merge (per_lobe) equals the
per-column loop it replaced exactly, and the JAX package's merge under the
same bar; a stack equals its single calls exactly; the range blocks
change nothing against refine_from_lobes over the whole range axis. The CUDA kernel is held to this plain version bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import zlib

import numpy as np
import pytest
import torch

from fwav_tpu.ops.search import refine_from_lobes as jax_refine
from fwav_tpu_torch.ops import kernels, near_tie
from fwav_tpu_torch.ops.search import refine_from_lobes

torch.set_num_threads(2)

#: Scores of equal picks: relative agreement with the JAX package.
SCORE_RTOL = 1e-6


def _inputs(seed, stride, C, N, n_valid, M=600, D=None):
    """A smooth bank (a random walk's taps 16 apart), zero from n_valid on;
    ranges; lobes over every subsampled row and one past them, -1 among
    them, lobe 0 (a window cut at row 0) and the last rows (a window cut
    at n_valid) planted."""
    rng = np.random.default_rng(seed)
    if D is None:
        D = 12 * stride + 4096
    x = np.cumsum(rng.standard_normal(D + 16 * N)).astype(np.float32) * 0.05
    bank = np.stack([x[j * 16 : j * 16 + D] for j in range(N)], axis=1)
    bank[n_valid:] = 0.0
    ranges = (rng.standard_normal((M, N)) * 0.3).astype(np.float32)
    lobes = rng.integers(-1, D // stride + 1, (M, C)).astype(np.int32)
    lobes[::7, 0] = 0
    lobes[1::11, -1] = max(n_valid - 1, 0) // stride
    lobes[2::13] = -1
    return ranges, bank, lobes


def _jax(ranges, bank, n_valid, lobes, stride, objective, s_clip=2.0):
    D = bank.shape[0]
    i, *_, s = jax_refine(ranges, bank, np.arange(D) < n_valid, lobes, stride, s_clip,
                          objective, return_score=True)
    return np.asarray(s), np.asarray(i)


def _port(ranges, bank, n_valid, lobes, stride, objective, s_clip=2.0, **kw):
    i, s = kernels.staged_refine(torch.from_numpy(ranges), torch.from_numpy(bank),
                                 torch.tensor([n_valid], dtype=torch.int32),
                                 torch.from_numpy(lobes), stride, objective, s_clip, **kw)
    return s.numpy(), i.numpy()


def _hold(name, got, want):
    """The near-tie bar on idx, SCORE_RTOL on the scores of equal picks."""
    check = near_tie.check_argmax(name, got, want)
    same = np.isfinite(want[0]) & (got[1] == want[1])
    np.testing.assert_allclose(got[0][same], want[0][same], rtol=SCORE_RTOL, atol=0)
    return check


#: (case, stride, lobe columns, range size, n_valid): the branch each takes.
CASES = [
    ("descent_16_4_stride128", 128, 1, 4, 11 * 128 + 301),
    ("descent_16_4_stride512", 512, 1, 4, 11 * 512 + 301),
    ("stage_8_stride32", 32, 1, 4, 11 * 32 + 301),
    ("dense_c2", 128, 2, 4, 11 * 128 + 301),
    ("dense_c4_n8", 64, 4, 8, 11 * 64 + 301),
    ("dense_stride16", 16, 1, 4, 11 * 16 + 301),
    ("descent_n32", 128, 1, 32, 11 * 128 + 301),
    ("dense_c4_n32", 128, 4, 32, 11 * 128 + 301),
    ("n_valid_under_w_descent", 512, 1, 4, 300),
    ("n_valid_under_w_dense", 128, 4, 8, 100),
    ("n_valid_1", 128, 1, 4, 1),
    ("n_valid_0_dense", 64, 2, 4, 0),
]


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("case,stride,C,N,n_valid", CASES, ids=[c[0] for c in CASES])
def test_staged_refine_ref_matches_jax(case, stride, C, N, n_valid, objective):
    ranges, bank, lobes = _inputs(zlib.crc32(case.encode()), stride, C, N, n_valid)
    got = _port(ranges, bank, n_valid, lobes, stride, objective)
    want = _jax(ranges, bank, n_valid, lobes, stride, objective)
    check = _hold(case, got, want)
    fin = np.isfinite(want[0])
    assert (got[1][fin] < n_valid).all()
    if n_valid == 0:
        assert not fin.any()
    else:
        assert fin.sum() >= 0.8 * len(fin) and check["finite"] == int(fin.sum())
    # a range with no finite score: the row of the plain version's pick
    # (the first of its last window, clamped), as the JAX function's
    np.testing.assert_array_equal(got[1][~fin], want[1][~fin])


def _old_global_loop(ranges, bank, n_valid: int, lobes, stride, objective, s_clip, grblk):
    """The global pass's refine as models/encode.py encode_core_global ran
    it before K4: per range block, each lobe column alone, merged with a
    strict >."""
    mb = ranges.shape[0]
    best_i = torch.zeros(mb, dtype=torch.int32)
    best_s = torch.full((mb,), float("-inf"))
    for r0 in range(0, mb, grblk):
        rb = ranges[r0 : r0 + grblk]
        bi, bs = best_i[r0 : r0 + grblk], best_s[r0 : r0 + grblk]
        for c in range(lobes.shape[1]):
            i_c, s_c = refine_from_lobes(rb, bank, n_valid, lobes[r0 : r0 + grblk, c : c + 1],
                                         stride, s_clip, objective)
            take = s_c > bs
            bs.copy_(torch.where(take, s_c, bs))
            bi.copy_(torch.where(take, i_c, bi))
    return best_i, best_s


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("stride,N,n_valid", [(512, 4, 11 * 512 + 301), (64, 4, 900),
                                              (16, 4, 11 * 16 + 301), (128, 32, 300)])
def test_per_lobe_merge_is_the_global_pass_loop(objective, stride, N, n_valid):
    """per_lobe equals the loop it replaced, exactly (blocks of 64 ranges
    there, of 32,768 here), with repeated lobes planted for exact ties;
    and the JAX package's merge (fwav_tpu/models/encode.py, the global
    pass's lax.map) under the bar."""
    ranges, bank, lobes = _inputs(stride + N, stride, 4, N, n_valid)
    lobes[3::17, 2] = lobes[3::17, 0]  # the earlier lobe wins the tie
    r, b, lob = (torch.from_numpy(x) for x in (ranges, bank, lobes))
    want = _old_global_loop(r, b, n_valid, lob, stride, objective, 2.0, 64)
    got = kernels.staged_refine_ref(r, b, n_valid, lob, stride, objective, 2.0, per_lobe=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).any() and not got[0][~torch.isfinite(got[1])].any()
    js = np.full(len(ranges), -np.inf, np.float32)
    ji = np.zeros(len(ranges), np.int32)
    for c in range(4):
        s_c, i_c = _jax(ranges, bank, n_valid, lobes[:, c : c + 1], stride, objective)
        take = s_c > js
        js, ji = np.where(take, s_c, js), np.where(take, i_c, ji)
    _hold("per_lobe", (got[1].numpy(), got[0].numpy()), (js, ji))


@pytest.mark.parametrize("per_lobe", [False, True])
@pytest.mark.parametrize("stride,C,N", [(128, 1, 4), (64, 4, 4), (128, 1, 32)])
def test_stack_equals_single_calls(per_lobe, stride, C, N):
    """A stack of 3 files with their own n_valid (one under W) equals the
    3 single calls exactly."""
    n_valids = [11 * stride + 301, 7 * stride + 5, 100]
    files = [_inputs(40 + b, stride, C, N, nv, M=500, D=12 * stride + 1024)
             for b, nv in enumerate(n_valids)]
    r, b, lob = (torch.from_numpy(np.stack([f[k] for f in files])) for k in range(3))
    nv = torch.tensor(n_valids, dtype=torch.int32)
    for objective in ("balanced", "damped"):
        args = (stride, objective, 2.0, per_lobe)
        got = kernels.staged_refine(r, b, nv, lob, *args)
        assert got[0].shape == (3, 500) and got[0].dtype == torch.int32
        for k in range(3):
            one = kernels.staged_refine(r[k], b[k], nv[k : k + 1], lob[k], *args)
            assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])


@pytest.mark.parametrize("per_lobe", [False, True])
@pytest.mark.parametrize("stride,C,N", [(128, 1, 4), (64, 4, 4), (32, 1, 8)])
def test_range_blocks_change_nothing(monkeypatch, per_lobe, stride, C, N):
    """The plain version in blocks of 77 ranges equals refine_from_lobes
    over the whole range axis (per lobe column and merged with a strict >
    for per_lobe), exactly."""
    n_valid = 11 * stride + 301
    ranges, bank, lobes = _inputs(60 + stride, stride, C, N, n_valid, M=500)
    lobes[3::17, -1] = lobes[3::17, 0]
    r, b, lob = (torch.from_numpy(x) for x in (ranges, bank, lobes))
    monkeypatch.setattr(kernels, "_STAGED_REF_BLOCK", 77)
    for objective in ("balanced", "damped"):
        got = kernels.staged_refine_ref(r, b, n_valid, lob, stride, objective, 2.0, per_lobe)
        if per_lobe:
            want = _old_global_loop(r, b, n_valid, lob, stride, objective, 2.0, len(ranges))
        else:
            want = refine_from_lobes(r, b, n_valid, lob, stride, 2.0, objective)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.isfinite(got[1]).any()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper is the plain version and counts no
    launch; n_valid may be a 0-d tensor or an int there."""
    ranges, bank, lobes = _inputs(5, 128, 4, 4, 1000)
    r, b, lob = (torch.from_numpy(x) for x in (ranges, bank, lobes))
    kernels.reset_launch_counts()
    got = kernels.staged_refine(r, b, torch.tensor(1000, dtype=torch.int32), lob, 128,
                                "damped", 2.0)
    assert not any(kernels.LAUNCHES.values())
    want = refine_from_lobes(r, b, 1000, lob, 128, 2.0, "damped")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert "staged_refine" in kernels.LAUNCHES


def _window_gains_terms(monkeypatch, bank, r_c, objective, s_clip):
    """_window_gains of every bank row against each range (cand (D, M)),
    with the per-row terms it computes captured from its own calls: the
    mean (its row_mean), and w and the clip threshold (what it hands
    _gain_from_num). Returns (score (D, M), mean, w, thresh), each term
    (D, M); thresh None but for damped."""
    seen = {}
    real_mean, real_gain = kernels.row_mean, kernels._gain_from_num

    def row_mean(x):
        seen["mean"] = real_mean(x)
        return seen["mean"]

    def gain_from_num(num, weight, thresh, clip):
        seen["w"], seen["thresh"] = weight, thresh
        return real_gain(num, weight, thresh, clip)

    monkeypatch.setattr(kernels, "row_mean", row_mean)
    monkeypatch.setattr(kernels, "_gain_from_num", gain_from_num)
    D, M = bank.shape[0], r_c.shape[1]
    cand = torch.arange(D)[:, None].expand(D, M)
    score, _ = kernels._window_gains(r_c, bank, cand, torch.ones(D, M, dtype=torch.bool),
                                     objective, s_clip)
    monkeypatch.undo()
    return score, seen["mean"], seen["w"], seen["thresh"]


def _gains_from_table(r_c, bank, table, objective, s_clip):
    """What K4's scoring does with its table: each row centred by the
    table's mean, the two numerators summed tap by tap left to right, the
    gains with the table's w and threshold, the fold. Returns (D, M)."""
    N = bank.shape[1]
    d = bank - table[:, :1]
    w, th = table[:, 1, None], table[:, 2, None]
    no = d[:, 0:1] * r_c[0][None]
    nm = d[:, 0:1] * r_c[N - 1][None]
    for j in range(1, N):
        no = no + d[:, j : j + 1] * r_c[j][None]
        nm = nm + d[:, j : j + 1] * r_c[N - 1 - j][None]
    gains = []
    for num in (no, nm):
        g = num * num * w
        if objective == "damped":
            a = num.abs()
            g = torch.where(a > th, abs(s_clip) * (2.0 * a - th), g)
        gains.append(g)
    return torch.where(gains[1] > gains[0], gains[1], gains[0])


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("N", [4, 7, 32])
def test_staged_stats_ref_is_window_gains_row_terms(monkeypatch, objective, N):
    """K4's per-row table (staged_stats_ref) holds, bit for bit, the terms
    that _window_gains computes of each bank row: its mean, the weight w
    and the damped clip threshold (0 for the other objectives), taken from
    _window_gains' own calls; and scoring from the table gives
    _window_gains' gains bit for bit, with no division per scored row.
    The bank has zero rows past its n_valid, as K4's banks do."""
    stride, s_clip = 16, 2.0
    ranges, bank, _ = _inputs(N * 3 + len(objective), stride, 1, N, 11 * stride + 301, M=3)
    bank[::37] = bank[::37, :1]  # flat rows: a centred energy of 0
    r, b = torch.from_numpy(ranges), torch.from_numpy(bank)
    r_c = (r - kernels.row_mean(r)[:, None]).T
    score, mean, w, thresh = _window_gains_terms(monkeypatch, b, r_c, objective, s_clip)
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    table = kernels.staged_stats_ref(b, objective, s_clip)
    assert table.shape == (len(b), 4) and table.dtype == torch.float32
    assert torch.equal(bits(table[:, 0]), bits(mean[:, 0]))
    assert torch.equal(bits(table[:, 1]), bits(w[:, 0]))
    th = torch.zeros_like(w[:, 0]) if thresh is None else thresh[:, 0]
    assert torch.equal(bits(table[:, 2]), bits(th)) and not table[:, 3].any()
    assert (thresh is None) == (objective != "damped")
    got = _gains_from_table(r_c, b, table, objective, s_clip)
    assert torch.equal(bits(got), bits(score))
    stack = kernels.staged_stats_ref(torch.stack([b, b.flip(0)]), objective, s_clip)
    assert torch.equal(stack[0], table) and torch.equal(stack[1], table.flip(0))


@pytest.mark.parametrize("N,stride,C,per_lobe,table", [
    (4, 128, 1, False, False),   # the descent of a staged encode
    (4, 512, 4, True, False),    # the global pass: a descent per column
    (16, 32, 1, False, False),   # the (8,) descent
    (4, 128, 4, False, True),    # dense windows
    (4, 16, 1, False, True),     # one dense window at stride < 32
    (8, 16, 3, True, True),      # dense per column
    (17, 128, 1, False, True),   # wide ranges: always the table
    (32, 512, 4, True, True)])
def test_staged_uses_table(N, stride, C, per_lobe, table):
    """K4 scores through its table at dense windows and every range size
    over 16, and computes each row's terms in place at a descent of up to
    16 taps."""
    assert kernels.staged_uses_table(N, stride, C, per_lobe) is table
