"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch.cuda.is_available() is false. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K2 and its per-position table use their plain versions' order of
operations with explicit round-to-nearest arithmetic. K1 and K3 screen
every pair on the tensor cores (one BF16 m16n8k16 MMA per 64 pairs with a
three-term hi/lo split, csrc/scan_tile.cuh) within a proven margin and
confirm the pairs that can win with the plain versions' float32
arithmetic (csrc/scan_tile.cuh). So
on the same inputs each kernel agrees with its plain version bit for bit,
exact ties (duplicate bank rows) included, and the asserts hold them to
exactly that; the encodes on the card give the host runs' records. The
decode loop, torch ops on either device, is held to the host run within a
stated tolerance.
"""

import numpy as np
import pytest
import torch

import bench
import fwav_tpu_torch as port
from fwav_tpu_torch.ops import kernels
from fwav_tpu_torch.ops.affine import affine_stats
from fwav_tpu_torch.ops.search import domain_thresh, domain_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1(dev, seed, M, D, N, objective, prefix=False):
    """Seeded scan inputs; valid is random (every staged tile mixed), or
    with `prefix` the callers' valid prefix (whole tiles, then one mixed)."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((M, N)) * 0.5).astype(np.float32)
    bank = (rng.standard_normal((D, N)) * 0.1).astype(np.float32)
    bank[::41] = bank[::41, :1]
    r_c = torch.from_numpy(r - r.mean(1, keepdims=True)).to(dev)
    b = torch.from_numpy(bank).to(dev)
    mean, denom = affine_stats(b)
    valid = np.arange(D) < D - 37 if prefix else rng.random(D) > 0.05
    return (r_c, b.T.contiguous(), domain_weights(mean, denom, N, objective),
            torch.from_numpy(valid).to(dev), domain_thresh(denom, objective, 2.0), 2.0)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("M,D,N", [(1000, 3000, 4), (50, 20000, 4), (333, 1111, 7),
                                   (77, 1029, 4), (1003, 4099, 16)])
def test_search_scan_kernel_equals_plain(dev, objective, M, D, N):
    """Including a shape that splits the domains over blocks (few ranges,
    a large bank), range sizes other than 4, and ragged m16 and n8 edges
    (M and D not multiples of 8); every staged tile is mixed-valid."""
    args = _k1(dev, M + D, M, D, N, objective)
    before = kernels.LAUNCHES["search_scan"]
    s_k, i_k = kernels.search_scan(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["search_scan"] == before + 1
    s_p, i_p = kernels.search_scan_ref(*args)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)


def test_search_scan_kernel_all_invalid(dev):
    r_c, bankT, w, valid, t, c = _k1(dev, 5, 300, 700, 4, "balanced")
    s, i = kernels.search_scan(r_c, bankT, w, torch.zeros_like(valid))
    assert torch.isneginf(s).all() and not i.any()


def _k2(dev, seed, M, n, C, stride=128, B=256, dc=40, pad=1024):
    """Seeded K2 inputs: a box-mean sequence with its zero lead, (M, C)
    lobes in K3's layout (the transposed view of (C, M)) with -1 in any
    slot, whole rows of -1, past-the-end lobes and a repeated lobe, and
    n_valid short of the sequence, so windows are cut at both ends."""
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(dc * stride + n * B + 4096) * 0.2).astype(np.float32)
    means = np.convolve(sig, np.ones(B) / B, mode="valid").astype(np.float32)
    ext = np.zeros(stride + len(means) + pad, np.float32)
    ext[stride : stride + len(means)] = means
    lobes = rng.integers(-1, dc + 2, (C, M)).astype(np.int32)
    lobes[:, ::13] = -1
    lobes[0, 1::7] = 0
    if C > 1:
        lobes[C - 1, 2::5] = lobes[0, 2::5]
    ranges = (rng.standard_normal((M, n)) * 1.5).astype(np.float32)
    return (torch.from_numpy(ext).to(dev), torch.from_numpy(lobes).to(dev).T,
            torch.from_numpy(ranges).to(dev), dc * stride - 700, stride, B)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("n,C", [(4, 1), (4, 2), (4, 4), (4, 8), (16, 1), (16, 4), (7, 4)])
def test_refine_window_kernel_equals_plain(dev, objective, n, C):
    """Single-lobe (M,) and (M, C) forms, ragged M (3001 ranges: the last
    block's groups are partly empty), against the plain version, exactly."""
    ext, lobes, ranges, *geom = _k2(dev, 7 + n + C, 3001, n, C)
    before = dict(kernels.LAUNCHES)
    s_k, i_k = kernels.refine_window(ext, lobes, ranges, *geom, objective, 2.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_window"] == before["refine_window"] + 1
    assert kernels.LAUNCHES["window_stats"] == before["window_stats"] + 1
    s_p, i_p = kernels.refine_window_ref(ext, lobes, ranges, *geom, objective, 2.0)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)
    dead = (lobes < 0).all(1)
    assert dead.any() and torch.isneginf(s_k[dead]).all() and not i_k[dead].any()
    if C == 1:  # the (M,) form, and a row-major (M, C) tensor
        s_1, i_1 = kernels.refine_window(ext, lobes[:, 0].contiguous(), ranges, *geom,
                                         objective, 2.0)
        assert torch.equal(i_1, i_p) and torch.equal(s_1, s_p)
    else:
        s_c, i_c = kernels.refine_window(ext, lobes.contiguous(), ranges, *geom,
                                         objective, 2.0)
        assert torch.equal(i_c, i_p) and torch.equal(s_c, s_p)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("stride,B,pad", [(128, 250, 1024), (128, 256, 1023), (96, 256, 1024),
                                          (100, 256, 1024)])
def test_refine_window_kernel_unaligned_geometry(dev, objective, stride, B, pad):
    """A block length, a sequence length or a stride that keeps the windows
    off 16-byte boundaries takes the kernel's float-by-float loads."""
    ext, lobes, ranges, *geom = _k2(dev, 3, 1000, 4, 4, stride=stride, B=B, pad=pad)
    s_k, i_k = kernels.refine_window(ext, lobes, ranges, *geom, objective, 2.0)
    s_p, i_p = kernels.refine_window_ref(ext, lobes, ranges, *geom, objective, 2.0)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_refine_window_kernel_earlier_lobe_wins_exact_ties(dev, objective):
    """A box-mean sequence of period 4 strides: lobes a and a + 4 score the
    same bits at positions 4 strides apart; the lobe named first gives the
    position, as in the plain version."""
    ext, _, ranges, n_valid, stride, B = _k2(dev, 11, 500, 4, 1)
    period = 4 * stride
    ext = ext[stride : stride + period].repeat(ext.shape[0] // period + 1)[: ext.shape[0]]
    ext = ext.contiguous()
    a = torch.arange(500, dtype=torch.int32, device=dev) % 20 + 2
    for first, second in ((a, a + 4), (a + 4, a)):
        args = (ranges, n_valid, stride, B, objective, 2.0)
        s, i = kernels.refine_window(ext, torch.stack([first, second], dim=1), *args)
        s_1, i_1 = kernels.refine_window(ext, first.contiguous(), *args)
        s_2, i_2 = kernels.refine_window(ext, second.contiguous(), *args)
        assert torch.equal(s_1, s_2) and not torch.equal(i_1, i_2)  # exact ties
        assert torch.equal(s, s_1) and torch.equal(i, i_1)
        s_p, i_p = kernels.refine_window_ref(ext, torch.stack([first, second], dim=1), *args)
        assert torch.equal(s, s_p) and torch.equal(i, i_p)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("n,B", [(4, 256), (16, 64), (7, 250)])
def test_window_stats_kernel_equals_plain(dev, objective, n, B):
    ext = _k2(dev, 5, 8, n, 1, B=B, pad=1023)[0]
    before = kernels.LAUNCHES["window_stats"]
    got = kernels.window_stats(ext, n, B, objective)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_stats"] == before + 1
    assert torch.equal(got, kernels.window_stats_ref(ext, n, B, objective))


def test_refine_window_takes_a_given_table_and_checks_it(dev):
    ext, lobes, ranges, *geom = _k2(dev, 9, 300, 4, 4)
    stats = kernels.window_stats(ext, 4, geom[2], "damped")
    before = dict(kernels.LAUNCHES)
    got = kernels.refine_window(ext, lobes, ranges, *geom, "damped", 2.0, stats=stats)
    assert kernels.LAUNCHES["window_stats"] == before["window_stats"]
    want = kernels.refine_window_ref(ext, lobes, ranges, *geom, "damped", 2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="window_stats"):
        kernels.refine_window(ext, lobes, ranges, *geom, "damped", 2.0, stats=stats[:-1])
    with pytest.raises(ValueError, match="fewer than"):
        kernels.refine_window(ext[: geom[0]], lobes, ranges, *geom, "balanced", 2.0)
    with pytest.raises(TypeError, match="int32"):
        kernels.refine_window(ext, lobes.long(), ranges, *geom, "balanced", 2.0)


def test_kernel_wrappers_check_their_inputs(dev):
    r_c, bankT, w, valid, t, c = _k1(dev, 9, 64, 512, 4, "balanced")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.search_scan(r_c, bankT.T.contiguous().T, w, valid)
    with pytest.raises(ValueError, match="is on cpu"):
        kernels.search_scan(r_c, bankT, w.cpu(), valid)
    with pytest.raises(TypeError, match="dtype"):
        kernels.search_scan(r_c, bankT, w.double(), valid)


def test_slice_on_the_card_matches_the_host():
    """The 2 s slice on the card launches both kernels and gives the host
    run's records (the kernels pick what the plain versions pick)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sig = bench.make_signal(2.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, device="cuda")
    assert kernels.LAUNCHES == {"search_scan": 1, "topc_scan": 0, "refine_window": 1,
                                "window_stats": 1}
    cpu = port.compress_audio_arrays(sig, 44100, 2, device="cpu")
    np.testing.assert_array_equal(gpu[0].view(np.uint8), cpu[0].view(np.uint8))


def _k3(dev, seed, M, D, N, objective, ties):
    args = _k1(dev, seed, M, D, N, objective)
    if ties:  # every score occurs twice: bank rows D/2.. copy rows 0..
        r_c, bankT, w, valid, t, c = args
        h = D // 2
        bankT[:, h : 2 * h] = bankT[:, :h]
        w[h : 2 * h] = w[:h]
        valid[h : 2 * h] = valid[:h]
        if t is not None:
            t[h : 2 * h] = t[:h]
    return args


def _assert_lower_copy_first(lists, h):
    """Exact ties: domains h..2h-1 copy domains 0..h-1 and score the same,
    so in every list a copy ranks behind its lower original."""
    lists = lists.cpu().numpy()
    for row, pos in zip(*np.nonzero((lists >= h) & (lists < 2 * h))):
        assert (lists[row, :pos] == lists[row, pos] - h).any(), (row, lists[row])


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("N,ties", [(4, False), (4, True), (7, False), (16, False)])
def test_topc_scan_kernel_equals_plain(dev, objective, C, N, ties):
    r_c, bankT, w, valid, t, c = _k3(dev, 11 * C + N, 3000, 5000, N, objective, ties)
    before = kernels.LAUNCHES["topc_scan"]
    got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topc_scan"] == before + 1
    assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c))
    if ties:
        _assert_lower_copy_first(got, 5000 // 2)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("M,D,N,C", [(77, 1029, 4, 1), (1003, 4099, 16, 8),
                                     (2000, 640, 4, 4)])
def test_scan_kernels_prefix_valid_and_exact_ties(dev, objective, M, D, N, C):
    """The callers' valid prefix (wholly valid tiles take the unmasked
    epilogue, the prefix's end a masked one), ragged m16 and n8 edges, and
    a bank whose second half copies its first: the lower copy wins every
    exact tie, in K1's argmax and in K3's lists."""
    args = _k1(dev, M + D + C, M, D, N, objective, prefix=True)
    r_c, bankT, w, valid, t, c = args
    h = (D - 37) // 2
    bankT[:, h : 2 * h] = bankT[:, :h]
    w[h : 2 * h] = w[:h]
    if t is not None:
        t[h : 2 * h] = t[:h]
    s_k, i_k = kernels.search_scan(*args)
    s_p, i_p = kernels.search_scan_ref(*args)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    _assert_lower_copy_first(i_k[:, None], h)
    lists = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
    assert torch.equal(lists, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c))
    _assert_lower_copy_first(lists, h)


def test_topc_scan_kernel_unfilled_and_all_invalid(dev):
    r_c, bankT, w, valid, t, c = _k1(dev, 3, 700, 900, 4, "damped")
    few = torch.zeros_like(valid)
    few[[3, 400]] = True  # two valid domains for C = 4: the rest is -1
    for v in (few, torch.zeros_like(valid)):
        got = kernels.topc_scan(r_c, bankT, w, v, 4, t, c)
        assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, v, 4, t, c))
        assert (got[:, int(v.sum()) :] == -1).all() and (got[:, : int(v.sum())] >= 0).all()


def test_damped_slice_on_the_card_matches_the_host():
    """The 2 s damped slice on the card runs K3 once and K2 once over all
    four lobes and gives the host run's records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sig = bench.make_signal(2.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, objective="damped", device="cuda")
    assert kernels.LAUNCHES == {"search_scan": 0, "topc_scan": 1, "refine_window": 1,
                                "window_stats": 1}
    cpu = port.compress_audio_arrays(sig, 44100, 2, objective="damped", device="cpu")
    np.testing.assert_array_equal(gpu[0].view(np.uint8), cpu[0].view(np.uint8))


@pytest.mark.parametrize("s_damping,iterations", [(0.25, 8), (0.3, 40), (-0.5, 3)])
def test_decode_loop_on_the_card_matches_the_host(dev, monkeypatch, s_damping, iterations):
    """The loop's per-range arithmetic is the same elementwise sequence on
    both devices; only the norms of the stop test sum in another order.
    Bar: atol 1e-5 on unit-scale samples, the same iteration count."""
    from fwav_tpu_torch.models import decode

    monkeypatch.setattr(decode, "DECODE_SHARD_RANGES", 1000)  # three chunks
    rng = np.random.default_rng(5)
    M, D, N = 2500, 300, 4
    bank = rng.standard_normal((D, N)).astype(np.float32)
    bank[7] = 1.5  # a flat tile: no centered energy
    rec = np.zeros(M, dtype=port.MATCH_DTYPE)
    rec["idx"] = rng.integers(0, D, M)
    rec["idx"][::11] = -1
    rec["idx"][5] = 7
    rec["s"] = rng.uniform(-3, 3, M)
    rec["o"] = rng.standard_normal(M)
    rec["sym"] = rng.integers(0, 2, M)
    out = {}
    for d in ("cuda", "cpu"):
        stats = {}
        out[d] = (port.decompress_audio(rec, bank, M, N, iterations=iterations,
                                        s_damping=s_damping, convergence_eps=1e-4,
                                        stats=stats, device=d), stats)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-5)
    assert out["cuda"][1]["iterations"] == out["cpu"][1]["iterations"]


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_stream_on_the_card_matches_the_host(dev, objective):
    """The mid streaming fixture of tests/test_torch_stream.py (12 s at
    44.1 kHz, 5 shards of 2^17 samples with 2^15-sample halos) on the card:
    every shard launches its path's kernels (K1 then K2 balanced; K3 then
    K2 once over its lobes damped, and K3 once more in the damped global
    pass), and
    the records are the host run's up to near-ties: the same sentinels,
    at most 2 differing idx per 1,024 rows."""
    sig = bench.make_signal(12.0)
    kw = dict(shard_samples=1 << 17, halo=1 << 15, objective=objective)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_streaming(sig, 44100, 2, device="cuda", **kw)
    launches = dict(kernels.LAUNCHES)
    cpu = port.compress_audio_streaming(sig, 44100, 2, device="cpu", **kw)
    if objective == "damped":
        assert launches == {"search_scan": 0, "topc_scan": 6, "refine_window": 5,
                            "window_stats": 5}
    else:
        assert launches == {"search_scan": 5, "topc_scan": 0, "refine_window": 5,
                            "window_stats": 5}
    np.testing.assert_array_equal(gpu[0]["idx"] < 0, cpu[0]["idx"] < 0)
    assert int((gpu[0]["idx"] != cpu[0]["idx"]).sum()) <= 2 * -(-len(cpu[0]) // 1024)


def test_argmax_keeps_the_first_max_on_the_card(dev):
    """The staged window refine's picks: argmax over the K axis of a
    (K, M) score takes the first of exact ties on the card too."""
    s = torch.tensor([[1.0, float("-inf"), 3.0], [2.0, float("-inf"), 3.0],
                      [2.0, float("-inf"), 1.0]], device=dev)
    assert s.argmax(0).tolist() == [1, 0, 0]
    big = torch.zeros((41, 1 << 16), device=dev)
    big[[7, 30]] = 1.0
    assert (big.argmax(0) == 7).all()
