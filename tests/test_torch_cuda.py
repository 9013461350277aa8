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

#: The wide K1 and K3 (range sizes over 16), which these paths never launch.
NO_WIDE = {"search_scan_wide": 0, "topc_scan_wide": 0}
#: K4, the staged refine, and its table, which the window-refine paths
#: never launch.
NO_K4 = {"staged_refine": 0, "staged_stats": 0}
#: The serialized bank's kernel: one launch an encode of whole-valued
#: samples (every bench.make_signal file), none in the stream.
BANK = {"bank_means": 1}
NO_BANK = {"bank_means": 0}


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
                                "window_stats": 1, **NO_WIDE, **NO_K4, **BANK}
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
                                "window_stats": 1, **NO_WIDE, **NO_K4, **BANK}
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
                            "window_stats": 5, **NO_WIDE, "staged_refine": 1,
                            "staged_stats": 0, **NO_BANK}  # the pass's descent: no table
    else:
        assert launches == {"search_scan": 5, "topc_scan": 0, "refine_window": 5,
                            "window_stats": 5, **NO_WIDE, **NO_K4, **NO_BANK}
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


# --- stacks of files: one launch, the file axis in the kernel's grid --------


def _stack(files):
    """Per-file argument tuples -> one tuple with a leading file axis on
    every tensor (None stays None; scalars are the first file's)."""
    return tuple(
        torch.stack([f[k] for f in files]).contiguous() if torch.is_tensor(files[0][k])
        else files[0][k]
        for k in range(len(files[0]))
    )


def _k1_files(dev, B, M, D, N, objective):
    """B files' scan inputs: every second file has the callers' valid
    prefix, each cut at its own length; the others a random valid."""
    files = []
    for b in range(B):
        f = _k1(dev, 100 * b + M + D, M, D, N, objective, prefix=b % 2 == 0)
        if b % 2 == 0:
            f[3][D - 37 - 53 * b :] = False
        files.append(f)
    return files


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("B,M,D,N", [(3, 1000, 3000, 4), (16, 50, 20000, 4), (5, 333, 1111, 7),
                                     (2, 1003, 4099, 16), (16, 77, 1029, 4)])
def test_search_scan_stack_equals_single_launches(dev, objective, B, M, D, N):
    """One launch over B files (ragged M and D; a shape whose single
    launch splits the domains and whose stack does not) gives, bit for bit,
    the B single launches and the plain version's loop."""
    files = _k1_files(dev, B, M, D, N, objective)
    stack = _stack(files)
    before = kernels.LAUNCHES["search_scan"]
    s, i = kernels.search_scan(*stack)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["search_scan"] == before + 1
    assert s.shape == (B, M) and i.shape == (B, M)
    for b, f in enumerate(files):
        s_b, i_b = kernels.search_scan(*f)
        assert torch.equal(i[b], i_b) and torch.equal(s[b], s_b), b
    s_p, i_p = kernels.search_scan_ref(*stack)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("B,M,D,N,C", [(3, 3000, 5000, 4, 4), (16, 77, 1029, 4, 1),
                                       (4, 1003, 4099, 16, 8), (7, 333, 1111, 7, 2)])
def test_topc_scan_stack_equals_single_launches(dev, objective, B, M, D, N, C):
    files = _k1_files(dev, B, M, D, N, objective)
    r_c, bankT, w, valid, t, c = _stack(files)
    before = kernels.LAUNCHES["topc_scan"]
    got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topc_scan"] == before + 1
    assert got.shape == (B, M, C)
    for b, f in enumerate(files):
        assert torch.equal(got[b], kernels.topc_scan(*f[:4], C, f[4], f[5])), b
    assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c))


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("B,M,n,C,pad", [(3, 3001, 4, 4, 1024), (16, 500, 4, 1, 1024),
                                         (5, 777, 7, 2, 1023), (2, 1000, 16, 8, 1024)])
def test_refine_window_stack_equals_single_launches(dev, objective, B, M, n, C, pad):
    """K2 and its table over B files whose n_valid differ (pad 1023 keeps
    every file but the first off the 16-byte loads' alignment: the launch
    then reads float by float, as each single launch does)."""
    files = [_k2(dev, 31 * b + n + C, M, n, C, pad=pad) for b in range(B)]
    ext, ranges = (torch.stack([f[k] for f in files]) for k in (0, 2))
    # K3's layout: (B, C, M) seen as (B, M, C)
    lobes = torch.stack([f[1].T for f in files]).transpose(1, 2)
    assert not lobes.is_contiguous() or C == 1
    n_valid = [f[3] - 97 * b for b, f in enumerate(files)]
    stride, block_len = files[0][4:]
    before = dict(kernels.LAUNCHES)
    s, i = kernels.refine_window(ext, lobes, ranges, n_valid, stride, block_len,
                                 objective, 2.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_window"] == before["refine_window"] + 1
    assert kernels.LAUNCHES["window_stats"] == before["window_stats"] + 1
    table = kernels.window_stats(ext, n, block_len, objective)
    assert torch.equal(table, kernels.window_stats_ref(ext, n, block_len, objective))
    for b, f in enumerate(files):
        s_b, i_b = kernels.refine_window(f[0], f[1], f[2], n_valid[b], stride, block_len,
                                         objective, 2.0)
        assert torch.equal(i[b], i_b) and torch.equal(s[b], s_b), b
        assert torch.equal(table[b], kernels.window_stats(f[0], n, block_len, objective))
    s_p, i_p = kernels.refine_window_ref(ext, lobes, ranges, n_valid, stride, block_len,
                                         objective, 2.0)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)
    # the (B, M) form, or a row-major (B, M, C) tensor
    other = lobes[:, :, 0].contiguous() if C == 1 else lobes.contiguous()
    s_1, i_1 = kernels.refine_window(ext, other, ranges, n_valid, stride, block_len,
                                     objective, 2.0)
    assert torch.equal(i_1, i) and torch.equal(s_1, s)


def test_refine_window_refuses_a_stack_over_16_files(dev):
    ext, lobes, ranges, n_valid, stride, block_len = _k2(dev, 2, 64, 4, 1)
    B = 17
    with pytest.raises(ValueError, match="no kernel for B=17"):
        kernels.refine_window(ext.expand(B, -1).contiguous(), lobes.expand(B, -1, -1),
                              ranges.expand(B, -1, -1).contiguous(), [n_valid] * B,
                              stride, block_len, "balanced", 2.0)


@pytest.mark.parametrize("kw,refine", [({}, "window"), ({"objective": "damped"}, "window"),
                                        ({"tile_size": 512}, "staged"),
                                        ({"tile_size": 512, "objective": "damped"}, "staged")])
def test_packed_encode_on_the_card_equals_the_single_encodes(dev, kw, refine):
    """A stack of three 3 s files of one bucket and one shorter file: every
    file's result equals its own single encode on the card exactly, the
    scan kernel launches once per stack, and K2 with its table where the
    plan takes the window refine, else K4 once per stack."""
    from fwav_tpu_torch.models import encode as enc

    base = bench.make_signal(3.0)
    sigs = []
    for k in range(3):
        rng = np.random.default_rng(50 + k)
        sigs.append(np.round(base * (0.6 + 0.1 * k)
                             + rng.normal(0, 20, len(base))).astype(np.float32))
    sigs.append(sigs[0][: 2 * 44100 + 123].copy())
    cfg = port.EncoderConfig(**kw)
    _, _, _, lb, db = enc._prep_signal(sigs[0], cfg)
    _, stride, plan = enc._plan_search(cfg, lb // cfg.range_size, db)
    assert plan == refine
    kernels.reset_launch_counts()
    packed = port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)
    launches = dict(kernels.LAUNCHES)
    scan = "topc_scan" if cfg.objective == "damped" else "search_scan"
    k2 = 2 if refine == "window" else 0
    assert launches[scan] == 2 and launches["refine_window"] == k2
    assert launches["window_stats"] == k2 and launches["staged_refine"] == 2 - k2
    table = kernels.staged_uses_table(cfg.range_size, stride, enc._coarse_topc(cfg), False)
    assert launches["staged_stats"] == (2 - k2) * table
    for sig, got in zip(sigs, packed):
        one = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        np.testing.assert_array_equal(got[0].view(np.uint8), one[0].view(np.uint8))
        np.testing.assert_array_equal(got[1], one[1])
        assert tuple(got[2:]) == tuple(one[2:])


def test_packed_clips_on_the_card_equal_the_single_encodes(dev):
    """A call shaped like a clip corpus's (16 kHz, 14 clips of 1 s and two
    of 0.5-1.0 s) takes the exact branch: K1 once per stack and no
    refine; every clip equals its own single encode on the card exactly."""
    from fwav_tpu_torch.models import encode as enc

    sig = np.round(bench.make_signal(15.5, 16000)).astype(np.float32)
    lengths = [16000] * 6 + [9000] + [16000] * 8 + [15000]
    starts = np.cumsum([0] + lengths[:-1])
    clips = [sig[a : a + n].copy() for a, n in zip(starts, lengths)]
    cfg = port.EncoderConfig()
    buckets = set()
    for c in clips:
        _, _, _, lb, db = enc._prep_signal(c, cfg)
        assert enc._plan_search(cfg, lb // cfg.range_size, db)[0] == "exact"
        buckets.add((lb, db))
    assert len(buckets) == 3
    kernels.reset_launch_counts()
    packed = port.compress_audio_packed(clips, 16000, 2, device="cuda")
    launches = dict(kernels.LAUNCHES)
    assert launches["search_scan"] == 3 and launches["bank_means"] == 3
    assert not any(launches[k] for k in ("topc_scan", "refine_window", "window_stats",
                                         "staged_refine", "staged_stats",
                                         "search_scan_wide", "topc_scan_wide"))
    assert kernels.PACKS["stacks"] == 3 and kernels.PACKS["stack_files"] == 16
    for c, got in zip(clips, packed):
        one = port.compress_audio_arrays(c, 16000, 2, device="cuda")
        np.testing.assert_array_equal(got[0].view(np.uint8), one[0].view(np.uint8))
        np.testing.assert_array_equal(got[1], one[1])
        assert tuple(got[2:]) == tuple(one[2:])


def _wav(tmp_path, seconds, sr=44100):
    path = tmp_path / "in.wav"
    port.write_wav(path, bench.make_signal(seconds, sr), sr, 2)
    return path


@pytest.mark.parametrize("flags", [[], ["--compact"]])
def test_cli_round_trip_on_the_card_equals_the_host(dev, tmp_path, flags):
    """`compress` and a bare `decompress` through the CLI with --device
    cuda: the file the host run writes (the kernels equal their plain
    versions bit for bit), and the decode within the card-vs-host bar."""
    from fwav_tpu_torch import cli

    wav = _wav(tmp_path, 2.0)
    out = {}
    for device in ("cuda", "cpu"):
        fwav = tmp_path / f"{device}.fwav"
        kernels.reset_launch_counts()
        assert cli.main(["compress", str(wav), str(fwav), "--device", device, *flags]) == 0
        launched = sum(kernels.LAUNCHES.values())
        assert launched > 0 if device == "cuda" else launched == 0
        recon = tmp_path / f"{device}_recon.wav"
        assert cli.main(["decompress", str(fwav), "--out", str(recon), "--device", device]) == 0
        out[device] = (fwav.read_bytes(), port.read_wav_mono(recon)[0])
    assert out["cuda"][0] == out["cpu"][0]
    assert np.max(np.abs(out["cuda"][1] - out["cpu"][1])) <= 1.0  # one 16-bit LSB


def test_topk_on_the_card_matches_the_host(dev):
    """search="topk" on the card (torch ops, TF32 off for the shortlist
    products; no search kernel launched) against the host run of one second of
    audio: the same sentinels, idx equal but at ties of the selection. Its
    bank, as every encode's of whole-valued samples, is bank_means'."""
    from fwav_tpu_torch.ops import near_tie

    sig = bench.make_signal(1.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, search="topk", device="cuda")[0]
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), **BANK}
    cpu = port.compress_audio_arrays(sig, 44100, 2, search="topk", device="cpu")[0]
    np.testing.assert_array_equal(gpu["idx"] < 0, cpu["idx"] < 0)
    assert int((gpu["idx"] != cpu["idx"]).sum()) <= near_tie.allowed_diffs(len(cpu))
    torch.backends.cuda.matmul.allow_tf32 = True  # the guard turns it off per call
    try:
        again = port.compress_audio_arrays(sig, 44100, 2, search="topk", device="cuda")[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_array_equal(again["idx"], gpu["idx"])


@pytest.mark.parametrize("seconds,kw,launches", [
    (2.0, {}, {"search_scan": 4, "topc_scan": 0, "refine_window": 4, "window_stats": 4,
               **NO_WIDE, **NO_K4, **BANK}),
    (2.0, {"objective": "damped"},
     {"search_scan": 0, "topc_scan": 4, "refine_window": 4, "window_stats": 4,
      **NO_WIDE, **NO_K4, **BANK}),
    (0.5, {"search": "exact"},
     {"search_scan": 4, "topc_scan": 0, "refine_window": 0, "window_stats": 0,
      **NO_WIDE, **NO_K4, **BANK}),
])
def test_repeated_card_mesh_matches_one_device(dev, seconds, kw, launches):
    """A (2, 2) mesh of four cells on cuda:0 (parallel/mesh.py) gives the
    records of the single-device encode on the card, coarse (one lobe and
    damped: the cells split the ranges, each runs K1 or K3 and K2 with its
    table once) and exact (each cell runs K1 once over its bank row
    shard); the serialized bank is one bank_means launch on the first
    cell."""
    from fwav_tpu_torch.parallel import Mesh, compress_audio_sharded

    sig = bench.make_signal(seconds)
    one = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
    kernels.reset_launch_counts()
    got = compress_audio_sharded(sig, 44100, 2, mesh=Mesh([["cuda:0"] * 2] * 2), **kw)
    assert kernels.LAUNCHES == launches
    np.testing.assert_array_equal(got[0].view(np.uint8), one[0].view(np.uint8))
    np.testing.assert_array_equal(got[1], one[1])


def test_reference_shaped_ops_run_on_the_card_by_default(dev):
    """The reference-shaped ops with their default device, "cuda", against
    the same calls on the host: the embeddings' explicit float32 sums give
    the host's values, the shortlists and picks are the host's."""
    from fwav_tpu_torch.ops import affine, dct, index, perceptual, search

    rng = np.random.default_rng(21)
    tile = rng.standard_normal(8).astype(np.float32)
    bank = rng.standard_normal((40, 8)).astype(np.float32)
    for fn in (dct.tile_embedding, dct.transient_embedding, dct.tonal_embedding,
               dct.multi_head_embedding):
        np.testing.assert_allclose(fn(tile), fn(tile, device="cpu"), rtol=0, atol=1e-6)
    embs = dct.multi_head_embedding_batch(torch.from_numpy(bank)).numpy()
    q = rng.standard_normal((5, 16)).astype(np.float32)
    got = index.MIPSIndex(embs).query(q, top_k=8)
    want = index.MIPSIndex(embs).query(q, top_k=8, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(search.range_candidates_from_embedding(tile, embs, top_k=8),
                                  search.range_candidates_from_embedding(tile, embs, top_k=8,
                                                                         device="cpu"))
    a = affine.find_best_domain_affine(tile, bank, [3, 7, 11])
    b = affine.find_best_domain_affine(tile, bank, [3, 7, 11], device="cpu")
    assert a[0] == b[0] and a[3] == b[3]
    np.testing.assert_allclose(a[1:3] + a[4:], b[1:3] + b[4:], rtol=1e-5, atol=1e-5)
    one = affine.affine_solve_single(tile, bank[2])
    assert all(x.device.type == "cuda" for x in one)
    np.testing.assert_allclose([float(x) for x in one],
                               [float(x) for x in affine.affine_solve_single(tile, bank[2],
                                                                             device="cpu")],
                               rtol=1e-5, atol=1e-5)
    err = perceptual.perceptual_error_batch(bank, tile)
    assert err.device.type == "cuda"
    np.testing.assert_allclose(err.cpu().numpy(),
                               perceptual.perceptual_error_batch(bank, tile, device="cpu").numpy(),
                               rtol=1e-5)
    a = perceptual.pruned_affine_search(tile, list(range(40)), bank)
    b = perceptual.pruned_affine_search(tile, list(range(40)), bank, device="cpu")
    assert a[0] == b[0] and a[3] == b[3]
    np.testing.assert_allclose(a[1:3] + a[4:], b[1:3] + b[4:], rtol=1e-5, atol=1e-5)


# --- range sizes over 16: the wide scans (csrc/scan_wide.cuh) ------------------


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("M,D,N", [(1000, 3000, 17), (333, 1111, 32), (50, 20000, 64),
                                   (77, 1029, 255)])
def test_wide_search_scan_equals_plain(dev, objective, M, D, N):
    """K1 at range sizes 17 to 255: every staged tile mixed-valid, ragged
    range blocks and tiles, duplicate bank rows (exact ties), and a shape
    whose domains split over blocks (few ranges, a large bank)."""
    args = _k1(dev, M + D + N, M, D, N, objective)
    before = dict(kernels.LAUNCHES)
    s_k, i_k = kernels.search_scan(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, "search_scan_wide": before["search_scan_wide"] + 1}
    s_p, i_p = kernels.search_scan_ref(*args)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("N,ties", [(17, False), (32, True), (64, False)])
def test_wide_topc_scan_equals_plain(dev, objective, C, N, ties):
    r_c, bankT, w, valid, t, c = _k3(dev, 13 * C + N, 1500, 2000, N, objective, ties)
    before = dict(kernels.LAUNCHES)
    got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
    assert kernels.LAUNCHES == {**before, "topc_scan_wide": before["topc_scan_wide"] + 1}
    assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c))
    if ties:
        _assert_lower_copy_first(got, 2000 // 2)


def test_wide_scans_stack_equals_single_launches(dev):
    """A stack of 3 files at N = 32 in one launch of each wide kernel."""
    files = [_k1(dev, 70 + b, 500, 900, 32, "damped") for b in range(3)]
    st = [torch.stack([f[k] for f in files]) for k in range(5)]
    s, i = kernels.search_scan(*st, 2.0)
    lists = kernels.topc_scan(*st[:4], 4, st[4], 2.0)
    for b, f in enumerate(files):
        s_b, i_b = kernels.search_scan(*f)
        assert torch.equal(s[b], s_b) and torch.equal(i[b], i_b)
        assert torch.equal(lists[b], kernels.topc_scan(*f[:4], 4, f[4], f[5]))


#: Range sizes of the wide sweep: chunk boundaries (4 taps a chunk), and
#: every block-shape class of csrc/scan_wide.cuh and its edges (up to 64,
#: 128 and 255 taps).
WIDE_SWEEP_N = [17, 19, 31, 33, 48, 64, 65, 100, 128, 129, 200, 255]


def _wide_planted(dev, seed, M, D, N, objective):
    """_k1's inputs with what hurts a screen planted: negative balanced
    weights, a zero range, a whole 128-domain tile without a valid domain,
    bank rows copied exactly (h..h+39 of 0..39) and copies whose last tap
    moves by one ulp (2h..2h+39 of 40..79)."""
    r_c, bankT, w, valid, t, c = _k1(dev, seed, M, D, N, objective)
    r_c[3] = 0
    if objective == "balanced":
        w[::7] = -w[::7].abs()
    valid[128:256] = False
    h = D // 3
    bankT[:, h : h + 40] = bankT[:, :40]
    bankT[:, 2 * h : 2 * h + 40] = bankT[:, 40:80]
    bankT[N - 1, 2 * h : 2 * h + 40] = torch.nextafter(bankT[N - 1, 40:80],
                                                       torch.tensor(1.0, device=dev))
    for x in (w, t, valid):
        if x is not None:
            x[h : h + 40] = x[:40]
            x[2 * h : 2 * h + 40] = x[40:80]
    return r_c, bankT, w, valid, t, c


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("N", WIDE_SWEEP_N)
def test_wide_scans_sweep_equal_plain(dev, objective, N):
    """K1 and K3 (C 1, 2, 4, 8) at every range size of the sweep, on
    planted inputs (_wide_planted), ragged range blocks and tiles, against
    their plain versions, exactly; one launch each under the wide keys."""
    r_c, bankT, w, valid, t, c = _wide_planted(dev, 31 * N + len(objective), 300 + N % 7,
                                               1500 + 3 * N, N, objective)
    before = dict(kernels.LAUNCHES)
    s_k, i_k = kernels.search_scan(r_c, bankT, w, valid, t, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, "search_scan_wide": before["search_scan_wide"] + 1}
    s_p, i_p = kernels.search_scan_ref(r_c, bankT, w, valid, t, c)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    for C in (1, 2, 4, 8):
        got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
        assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c)), C
    assert kernels.LAUNCHES["topc_scan_wide"] == before["topc_scan_wide"] + 4


@pytest.mark.parametrize("objective", ["balanced", "damped"])
def test_wide_scans_planted_near_ties_at_255(dev, objective):
    """At 255 taps a bank whose second half copies its first exactly, and
    whose third quarter is a copy with the last tap one ulp off: the lower
    copy wins every exact tie, and the one-ulp rows are picked only where
    the plain version picks them."""
    N, M, D = 255, 500, 2000
    r_c, bankT, w, valid, t, c = _k1(dev, 77, M, D, N, objective)
    h = D // 2
    bankT[:, h:] = bankT[:, :h]
    bankT[N - 1, h : h + h // 2] = torch.nextafter(bankT[N - 1, : h // 2],
                                                   torch.tensor(-1.0, device=dev))
    for x in (w, t, valid):
        if x is not None:
            x[h:] = x[:h]
    s_k, i_k = kernels.search_scan(r_c, bankT, w, valid, t, c)
    s_p, i_p = kernels.search_scan_ref(r_c, bankT, w, valid, t, c)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    for C in (1, 4, 8):
        got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
        assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c)), C
    exact = i_k[(i_k >= h + h // 2)]  # exact copies never win over their originals
    assert exact.numel() == 0


@pytest.mark.parametrize("objective", ["balanced", "damped"])
@pytest.mark.parametrize("N", [17, 64, 255])
def test_wide_scans_tiny_ranges_equal_plain(dev, objective, N):
    """Ranges scaled to 1e-23..1e-21 (one factor a range): num^2 w falls
    into float32's subnormals or to 0, so many scores tie and the plain
    version picks the lowest index, and the ranges' sums of squares
    underflow. K1 and K3 (C 1, 4, 8) pick exactly what the plain versions
    pick (csrc/scan_wide.cuh parts (5)-(7): the margins' absolute term,
    the norms bounded from above), the first tile's bound included."""
    r_c, bankT, w, valid, t, c = _k1(dev, 900 + N, 600, 3000, N, objective)
    scale = 10.0 ** np.random.default_rng(N).uniform(-23, -21, (r_c.shape[0], 1))
    r_c *= torch.from_numpy(scale.astype(np.float32)).to(dev)
    s_k, i_k = kernels.search_scan(r_c, bankT, w, valid, t, c)
    s_p, i_p = kernels.search_scan_ref(r_c, bankT, w, valid, t, c)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    assert (s_p[s_p > 0] < 1e-20).all()  # the scores are tiny indeed
    for C in (1, 4, 8):
        got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
        assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c)), C


@pytest.mark.parametrize("N", [64, 255])
def test_wide_search_scan_splits_the_domains(dev, N):
    """Few ranges and a large bank: the wrapper splits the domains over
    blockIdx.y (a multiple of 128 each) and the merge keeps the lowest
    index; the bank's second half copies its first."""
    r_c, bankT, w, valid, t, c = _k1(dev, 5 + N, 50, 20000, N, "balanced")
    bankT[:, 10000:] = bankT[:, :10000]
    w[10000:] = w[:10000]
    valid[10000:] = valid[:10000]
    s_k, i_k = kernels.search_scan(r_c, bankT, w, valid)
    s_p, i_p = kernels.search_scan_ref(r_c, bankT, w, valid)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    assert (i_k < 10000).all()


@pytest.mark.parametrize("N", [64, 255])
def test_wide_scans_stack_of_3_equals_single_launches(dev, N):
    """A stack of 3 files in one launch of each wide kernel, bit for bit
    its single launches and the plain versions' loop."""
    files = _k1_files(dev, 3, 400, 1300, N, "damped")
    st = _stack(files)
    s, i = kernels.search_scan(*st)
    lists = kernels.topc_scan(*st[:4], 4, st[4], st[5])
    for b, f in enumerate(files):
        s_b, i_b = kernels.search_scan(*f)
        assert torch.equal(s[b], s_b) and torch.equal(i[b], i_b), b
        assert torch.equal(lists[b], kernels.topc_scan(*f[:4], 4, f[4], f[5])), b
    s_p, i_p = kernels.search_scan_ref(*st)
    assert torch.equal(s, s_p) and torch.equal(i, i_p)
    assert torch.equal(lists, kernels.topc_scan_ref(*st[:4], 4, st[4], st[5]))


def test_window_refine_refuses_wide_ranges(dev):
    """K2 and its table stop at 16 taps, and say why."""
    ext, lobes, ranges, n_valid, stride, block_len = _k2(dev, 2, 64, 17, 1)
    with pytest.raises(ValueError, match="range sizes 4..16"):
        kernels.refine_window(ext, lobes, ranges, n_valid, stride, block_len, "balanced", 2.0)
    with pytest.raises(ValueError, match="staged refine"):
        kernels.window_stats(ext, 17, block_len, "balanced")


@pytest.mark.parametrize("kw", [{"tile_size": 8192}, {"tile_size": 8192, "objective": "damped",
                                                      "search": "coarse"},
                                {"tile_size": 16384}])
def test_wide_tile_encode_on_the_card_matches_the_host(dev, kw):
    """Range sizes 32 and 64 on the card: one launch of the wide K1 or
    K3, counted under its own key, then on the coarse plan K4 once (3 s
    takes the exact plan unless asked for "coarse"), and the host run's
    records."""
    sig = bench.make_signal(3.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
    scan = "topc_scan_wide" if kw.get("objective") == "damped" else "search_scan_wide"
    k4 = int(kw.get("search") == "coarse")
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), scan: 1,
                                "staged_refine": k4, "staged_stats": k4, **BANK}
    cpu = port.compress_audio_arrays(sig, 44100, 2, device="cpu", **kw)
    np.testing.assert_array_equal(gpu[0].view(np.uint8), cpu[0].view(np.uint8))


# --- the captured programs (models/program.py) ---------------------------------


def test_refine_window_reads_n_valid_from_the_device(dev):
    """K2 with n_valid as an int32 device tensor gives the int form's bits,
    and a launch captured in a CUDA graph follows the tensor's value at
    each replay."""
    files = [_k2(dev, 40 + b, 700, 4, 2) for b in range(2)]
    ext, ranges = (torch.stack([f[k] for f in files]) for k in (0, 2))
    lobes = torch.stack([f[1] for f in files])
    stride, block_len = files[0][4:]
    ints = [files[0][3], files[1][3] - 300]
    nv = torch.tensor(ints, dtype=torch.int32, device=dev)
    want = kernels.refine_window(ext, lobes, ranges, ints, stride, block_len, "damped", 2.0)
    got = kernels.refine_window(ext, lobes, ranges, nv, stride, block_len, "damped", 2.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    stats = kernels.window_stats(ext, 4, block_len, "damped")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.refine_window(ext, lobes, ranges, nv, stride, block_len, "damped", 2.0,
                                    stats=stats)
    for shift in (0, 500, 1000):
        nv.copy_(torch.tensor([ints[0] - shift, ints[1]], dtype=torch.int32))
        graph.replay()
        ref = kernels.refine_window_ref(ext, lobes, ranges, [ints[0] - shift, ints[1]], stride,
                                        block_len, "damped", 2.0)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), shift


def test_refine_window_refuses_host_ints_under_capture(dev):
    """Host ints would be baked into a captured launch: under a capture
    n_valid must be the device tensor."""
    ext, lobes, ranges, n_valid, stride, block_len = _k2(dev, 40, 700, 4, 2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(TypeError, match="under a graph capture"):
        with torch.cuda.graph(graph):
            kernels.refine_window(ext, lobes, ranges, n_valid, stride, block_len, "damped",
                                  2.0)


def _eager(monkeypatch):
    from fwav_tpu_torch.models import encode, stream

    monkeypatch.setattr(encode, "_captured", lambda *a: False)
    monkeypatch.setattr(stream, "_captured", lambda *a: False)


@pytest.mark.parametrize("kw", [{}, {"objective": "damped"}, {"search": "exact"},
                                {"tile_size": 512}, {"tile_size": 512, "objective": "damped"}])
def test_captured_encode_replays_the_eager_records(dev, monkeypatch, kw):
    """Two lengths of one bucket through one capture, each with the eager
    run's records and launch counts; a packed stack alike. Tile 512 takes
    the staged refine (K4)."""
    from fwav_tpu_torch.models.program import PROGRAMS

    sig = bench.make_signal(2.0)
    sigs = [sig, sig[:-2000]]
    with monkeypatch.context() as m:
        _eager(m)
        want, counts = [], []
        for s in sigs:
            kernels.reset_launch_counts()
            want.append(port.compress_audio_arrays(s, 44100, 2, device="cuda", **kw))
            counts.append(dict(kernels.LAUNCHES))
        stack = port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)
    PROGRAMS.clear()
    for rnd in range(2):  # first call, capture, two replays
        for s, w, c in zip(sigs, want, counts):
            kernels.reset_launch_counts()
            got = port.compress_audio_arrays(s, 44100, 2, device="cuda", **kw)
            assert kernels.LAUNCHES == c
            np.testing.assert_array_equal(got[0].view(np.uint8), w[0].view(np.uint8))
    st = PROGRAMS.stats()
    assert (st["first_calls"], st["captures"], st["replays"]) == (1, 1, 2)
    assert st["programs"][0]["nodes"]["kernel"] >= sum(counts[0].values())
    for _ in range(2):
        got = port.compress_audio_packed(sigs, 44100, 2, device="cuda", **kw)
        for a, b in zip(got, stack):
            np.testing.assert_array_equal(a[0].view(np.uint8), b[0].view(np.uint8))
    assert PROGRAMS.stats()["captures"] == 2


def test_captured_stream_replays_the_eager_records(dev, monkeypatch):
    """Every shard of a stream replays one program; the records are the
    eager run's."""
    from fwav_tpu_torch.models.program import PROGRAMS

    sig = bench.make_signal(12.0)
    kw = dict(shard_samples=1 << 17, halo=1 << 15, objective="damped")
    with monkeypatch.context() as m:
        _eager(m)
        want = port.compress_audio_streaming(sig, 44100, 2, device="cuda", **kw)[0]
    PROGRAMS.clear()
    got = port.compress_audio_streaming(sig, 44100, 2, device="cuda", **kw)[0]
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    st = PROGRAMS.stats()
    assert (st["first_calls"], st["captures"], st["replays"]) == (1, 1, 3)


def test_threads_replaying_one_key_keep_their_records(dev, monkeypatch):
    """Eight threads replay one program in turns, two lengths of its
    bucket, with a short switch interval: each call gets the records of its
    own file (the codes leave the graph's output before the lock is
    released)."""
    import sys
    import threading

    sig = bench.make_signal(2.0)
    sigs = [sig, sig[:-2000]]
    with monkeypatch.context() as m:
        _eager(m)
        want = [port.compress_audio_arrays(s, 44100, 2, device="cuda")[0] for s in sigs]
    for _ in range(2):  # a first call, then the capture
        port.compress_audio_arrays(sig, 44100, 2, device="cuda")
    bad, done = [], []

    def worker(k):
        for _ in range(5):
            got = port.compress_audio_arrays(sigs[k % 2], 44100, 2, device="cuda")[0]
            if got.tobytes() != want[k % 2].tobytes():
                bad.append(k)
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and not bad


# --- K4, the staged window refine (csrc/staged_refine.cu) ----------------------


def _k4(dev, seed, B, M, D, N, C, stride, n_valids, ties=False):
    """Seeded K4 inputs for a stack of B files: a smooth bank per file (a
    random walk's taps 16 apart), zero from its n_valid on; ranges; lobes
    over every subsampled row and one past, lobe 0 and -1 planted. With
    `ties`, every odd bank row repeats the row before it and a range's last
    lobe repeats its first: exact ties, where the first must win."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((B, D + 16 * N)), axis=1).astype(np.float32) * 0.05
    bank = np.stack([x[:, j * 16 : j * 16 + D] for j in range(N)], axis=2)
    if ties:
        bank[:, 1::2] = bank[:, 0 : D - 1 : 2]
    for b, nv in enumerate(n_valids):
        bank[b, nv:] = 0.0
    ranges = (rng.standard_normal((B, M, N)) * 0.3).astype(np.float32)
    lobes = rng.integers(-1, D // stride + 1, (B, M, C)).astype(np.int32)
    lobes[:, ::7, 0] = 0
    lobes[:, 2::13] = -1
    if ties and C > 1:
        lobes[:, 3::5, -1] = lobes[:, 3::5, 0]
    return (torch.from_numpy(ranges).to(dev), torch.from_numpy(bank).to(dev),
            torch.tensor(n_valids, dtype=torch.int32, device=dev),
            torch.from_numpy(lobes).to(dev))


def _bits_equal(got, want):
    """idx equal and the scores' float32 bits equal."""
    return torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                        want[1].view(torch.int32))


#: (stride, lobe columns, range size, per_lobe): every branch of K4.
K4_CASES = [(128, 1, 4, False),    # the (16, 4) descent
            (512, 4, 4, True),     # the global pass: each column's descent, merged
            (32, 1, 4, False),     # the (8,) stage
            (128, 4, 16, False),   # dense, 4 lobes
            (16, 1, 4, False),     # dense, one lobe at stride < 32
            (16, 3, 8, True),      # per column dense, merged
            (128, 1, 32, False),   # wide ranges: the descent
            (64, 4, 64, False),    # wide ranges: dense
            (128, 2, 7, False),    # a range size that is no multiple of 4
            (64, 4, 17, False),    # wide, no multiple of 4
            (512, 4, 128, True),   # wide per column descents: 41 samples, two rounds
            (128, 2, 255, False)]  # the widest ranges, dense


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("stride,C,N,per_lobe", K4_CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_staged_refine_kernel_equals_plain(dev, objective, stride, C, N, per_lobe, ties):
    """K4 against its plain version on the card, bit for bit: every branch,
    objective, range sizes 4 to 255, windows cut at both ends, n_valid under
    W, 1 and 0, planted exact ties; with the table made in the call where
    it pays (staged_uses_table: one launch of each kernel, else K4 alone),
    and the scoring alone on a table made before (chip_smoke.k4_score, as
    chip_smoke.py times it), at a descent too."""
    D = 12 * stride + 2048
    W = stride + stride // 4
    nvs = [11 * stride + 301, W - 3, 1, 0]
    args = _k4(dev, stride * 31 + C * 7 + N, len(nvs), 777, D, N, C, stride, nvs, ties)
    before = dict(kernels.LAUNCHES)
    got = kernels.staged_refine(*args, stride, objective, 2.0, per_lobe)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["staged_refine"] == before["staged_refine"] + 1
    table = kernels.staged_uses_table(N, stride, C, per_lobe)
    assert kernels.LAUNCHES["staged_stats"] == before["staged_stats"] + table
    want = kernels.staged_refine_ref(*args, stride, objective, 2.0, per_lobe)
    assert _bits_equal(got, want)
    assert torch.isfinite(got[1][0]).sum() > 600 and not torch.isfinite(got[1][3]).any()
    import chip_smoke

    stats = kernels.staged_stats(args[1], objective, 2.0)
    assert _bits_equal(chip_smoke.k4_score(kernels, *args, stride, objective, 2.0, per_lobe,
                                           stats), want)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("N", [4, 7, 16, 17, 32, 255])
def test_staged_stats_kernel_equals_plain(dev, objective, N):
    """K4's per-row table against its plain version on the card, bit for
    bit, for a stack of 3 banks (zero rows past n_valid, flat rows) in one
    launch and for one bank."""
    ranges, bank, nv, lobes = _k4(dev, 11 + N, 3, 10, 3000, N, 1, 128, [2900, 1500, 0])
    bank[:, ::37] = bank[:, ::37, :1]
    before = kernels.LAUNCHES["staged_stats"]
    got = kernels.staged_stats(bank, objective, 2.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["staged_stats"] == before + 1
    want = kernels.staged_stats_ref(bank, objective, 2.0)
    assert got.shape == (3, 3000, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    one = kernels.staged_stats(bank[1], objective, 2.0)
    assert torch.equal(one.view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("stride,C,N,per_lobe", [(128, 1, 4, False), (128, 4, 4, False),
                                                 (512, 4, 4, True), (128, 1, 32, False),
                                                 (128, 4, 32, False)])
def test_staged_refine_stack_of_16_equals_single_launches(dev, stride, C, N, per_lobe):
    """A stack of 16 files with their own n_valid in one launch: each file
    bit for bit its single launch (the dense 4 lobes at 32 taps: tile 8192
    damped, the wide kernel)."""
    nvs = [11 * stride + 301 - 97 * b for b in range(16)]
    ranges, bank, nv, lobes = _k4(dev, 90 + C, 16, 500, 12 * stride + 1024, N, C, stride, nvs)
    for objective in ("balanced", "damped"):
        geo = (stride, objective, 2.0, per_lobe)
        got = kernels.staged_refine(ranges, bank, nv, lobes, *geo)
        for b in range(16):
            one = kernels.staged_refine(ranges[b], bank[b], nv[b : b + 1], lobes[b], *geo)
            assert _bits_equal((got[0][b], got[1][b]), one), b
        assert _bits_equal(got, kernels.staged_refine_ref(ranges, bank, nv, lobes, *geo))


def test_staged_refine_reads_n_valid_from_the_device_under_capture(dev):
    """A K4 launch captured in a CUDA graph follows n_valid's value at each
    replay (nothing of it is baked into the launch), as the captured
    staged programs need; K3's transposed lobes are read through their
    strides."""
    stride, nvs = 128, [11 * 128 + 301, 9 * 128 + 7]
    ranges, bank, nv, lobes = _k4(dev, 7, 2, 900, 12 * 128 + 1024, 4, 4, stride, nvs)
    lobes_t = lobes.transpose(1, 2).contiguous().transpose(1, 2)  # K3's layout
    assert not lobes_t.is_contiguous()
    kernels.staged_refine(ranges, bank, nv, lobes_t, stride, "damped", 2.0)  # loads K4
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.staged_refine(ranges, bank, nv, lobes_t, stride, "damped", 2.0)
    for shift in (0, 300, 1100):
        cur = [nvs[0] - shift, nvs[1]]
        nv.copy_(torch.tensor(cur, dtype=torch.int32))
        graph.replay()
        want = kernels.staged_refine_ref(ranges, bank, cur, lobes, stride, "damped", 2.0)
        assert _bits_equal(out, want), shift


def test_staged_refine_never_runs_the_plain_version_on_the_card(dev, monkeypatch):
    """No fallback: on a CUDA tensor the wrapper launches K4 and its table
    or raises."""
    args = _k4(dev, 3, 1, 300, 4096, 4, 1, 128, [3000])
    want = kernels.staged_refine_ref(*args, 128, "balanced", 2.0)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(kernels, "staged_refine_ref", refuse)
    monkeypatch.setattr(kernels, "staged_stats_ref", refuse)
    assert _bits_equal(kernels.staged_refine(*args, 128, "balanced", 2.0), want)
    ranges, bank, nv, lobes = args
    with pytest.raises(TypeError, match="bank has dtype"):
        kernels.staged_stats(bank.double(), "balanced", 2.0)
    with pytest.raises(TypeError, match="n_valid must be an int32 tensor"):
        kernels.staged_refine(ranges, bank, [3000], lobes, 128, "balanced", 2.0)
    with pytest.raises(TypeError, match="lobes is torch.int64"):
        kernels.staged_refine(ranges, bank, nv, lobes.long(), 128, "balanced", 2.0)
    with pytest.raises(TypeError, match="n_valid has dtype"):
        kernels.staged_refine(ranges, bank, nv.long(), lobes, 128, "balanced", 2.0)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.staged_refine(ranges[..., :3].contiguous(), bank[..., :3].contiguous(), nv,
                              lobes, 128, "balanced", 2.0)
    with pytest.raises(ValueError, match="shapes disagree"):
        kernels.staged_refine(ranges, bank[..., :3].contiguous(), nv, lobes, 128, "balanced",
                              2.0)


def test_staged_encodes_launch_k4_once(dev):
    """A staged single-shot encode (tile 512) and the damped stream's
    global pass each launch K4 once, with its table where the windows are
    dense (damped), and the pass no longer runs the plain refine on the
    card."""
    sig = bench.make_signal(3.0)
    for kw, table in (({"tile_size": 512}, 0), ({"tile_size": 512, "objective": "damped"}, 1)):
        kernels.reset_launch_counts()
        port.compress_audio_arrays(sig, 44100, 2, device="cuda", **kw)
        assert kernels.LAUNCHES["staged_refine"] == 1
        assert kernels.LAUNCHES["staged_stats"] == table  # the balanced descent: none
    calls = []
    real = kernels.refine_from_lobes  # what the plain version calls
    kernels.refine_from_lobes = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        kernels.reset_launch_counts()
        port.compress_audio_streaming(bench.make_signal(12.0), 44100, 2, device="cuda",
                                      shard_samples=1 << 17, halo=1 << 15,
                                      objective="damped")
    finally:
        kernels.refine_from_lobes = real
    assert kernels.LAUNCHES["staged_refine"] == 1 and not kernels.LAUNCHES["staged_stats"]
    assert not calls


# --- the serialized bank (csrc/bank_means.cu) --------------------------------


def _bank_stack(lens, seed):
    """A zero-padded int16 stack of files of the given lengths: seeded
    full-range samples with an all-zero run and runs at +-32767."""
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lens), -(-max(lens) // 4096) * 4096), dtype=np.int16)
    for b, L in enumerate(lens):
        x[b, :L] = rng.integers(-32767, 32768, L)
        x[b, 1000:5000] = 0
        x[b, 9000:9600] = 32767
        x[b, 12000:12300] = -32767
    return x


@pytest.mark.parametrize("tile,step", [(1024, 1), (1500, 1), (4352, 4), (8192, 8),
                                       (1024, 3), (256, 1), (65280, 63)])
def test_bank_means_kernel_equals_the_host_build(dev, tile, step):
    """One launch over a stack of three files of different domain counts
    gives each file's build_domains_host bits and its plain version's:
    block lengths 64-300, steps 1-63, and at tile 65280 (255 columns of 256
    samples) the columns in passes."""
    from fwav_tpu_torch.ops.domains import build_domains_host, n_domains_for

    n = max(4, tile // 256)
    lens = [300000, 250001, 123457]
    x = _bank_stack(lens, tile + step)
    n_dom = [n_domains_for(L, tile, step) for L in lens]
    before = kernels.LAUNCHES["bank_means"]
    got = kernels.bank_means(torch.from_numpy(x).to(dev), n_dom, tile, n, step)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bank_means"] == before + 1
    plain = kernels.bank_means_ref(torch.from_numpy(x), n_dom, tile, n, step)
    for b, L in enumerate(lens):
        card = got[b, : n_dom[b]].cpu()
        assert torch.equal(card, plain[b, : n_dom[b]])
        want = build_domains_host(x[b, :L].astype(np.float32), tile, n, step)
        np.testing.assert_array_equal(card.numpy().view(np.uint32), want.view(np.uint32))


def test_bank_means_kernel_on_a_94s_file(dev):
    """The longest file of the benchmark's 70 s pool (94 s, 4,145,400
    samples, 4,144,377 rows of the default tile): the host build's bits."""
    from fwav_tpu_torch.ops.domains import build_domains_host, n_domains_for

    sig = bench.make_signal(94.0)
    x = np.zeros((1, -(-len(sig) // 4096) * 4096), dtype=np.int16)
    x[0, : len(sig)] = sig
    nd = n_domains_for(len(sig), 1024, 1)
    got = kernels.bank_means(torch.from_numpy(x).to(dev), [nd], 1024, 4, 1)[0, :nd]
    want = build_domains_host(sig, 1024, 4, 1)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))


def test_encodes_on_the_card_ship_the_host_bank(dev):
    """Every encode of whole-valued samples on the card builds its bank with
    bank_means (one launch a stack) and returns build_domains_host's bits:
    a packed stack of three lengths, and one file through its key's first
    call, capture and replay; samples that are no whole numbers keep the
    host build."""
    from fwav_tpu_torch.models.program import PROGRAMS
    from fwav_tpu_torch.ops.domains import build_domains_host

    base = bench.make_signal(3.5)
    sigs = [base, base[:150000].copy(), base[:140000].copy()]
    kernels.reset_launch_counts()
    res = port.compress_audio_packed(sigs, 44100, 2, device="cuda")
    assert kernels.LAUNCHES["bank_means"] == 1
    assert kernels.BANK_BUILDS == {"device": 3, "host": 0}
    for sig, r in zip(sigs, res):
        np.testing.assert_array_equal(r[1].view(np.uint32),
                                      build_domains_host(sig, 1024, 4, 1).view(np.uint32))
    PROGRAMS.clear()
    want = build_domains_host(sigs[1], 1024, 4, 1)
    for _ in range(3):  # first call, capture, replay
        got = port.compress_audio_arrays(sigs[1], 44100, 2, device="cuda")
        assert got[1].flags.c_contiguous
        np.testing.assert_array_equal(got[1].view(np.uint32), want.view(np.uint32))
    st = PROGRAMS.stats()
    assert (st["first_calls"], st["captures"], st["replays"]) == (1, 1, 1)
    assert kernels.BANK_BUILDS == {"device": 6, "host": 0}
    noisy = sigs[1] + np.float32(0.25)
    got = port.compress_audio_arrays(noisy, 44100, 2, device="cuda")
    assert kernels.BANK_BUILDS == {"device": 6, "host": 1}
    np.testing.assert_array_equal(got[1], build_domains_host(noisy, 1024, 4, 1))
