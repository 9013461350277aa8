"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch.cuda.is_available() is false. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels use the plain versions' order of operations with explicit
round-to-nearest arithmetic, so on the same inputs the two agree bit for
bit; the asserts hold them to exactly that. The decode loop, torch ops on
either device, is held to the host run within a stated tolerance.
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


def _k1(dev, seed, M, D, N, objective):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((M, N)) * 0.5).astype(np.float32)
    bank = (rng.standard_normal((D, N)) * 0.1).astype(np.float32)
    bank[::41] = bank[::41, :1]
    r_c = torch.from_numpy(r - r.mean(1, keepdims=True)).to(dev)
    b = torch.from_numpy(bank).to(dev)
    mean, denom = affine_stats(b)
    valid = torch.from_numpy(rng.random(D) > 0.05).to(dev)
    return (r_c, b.T.contiguous(), domain_weights(mean, denom, N, objective),
            valid, domain_thresh(denom, objective, 2.0), 2.0)


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("M,D,N", [(1000, 3000, 4), (50, 20000, 4), (333, 1111, 7)])
def test_search_scan_kernel_equals_plain(dev, objective, M, D, N):
    """Including a shape that splits the domains over blocks (few ranges,
    a large bank) and a range size other than 4."""
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


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
def test_refine_window_kernel_equals_plain(dev, objective):
    rng = np.random.default_rng(7)
    stride, B, n, dc, M = 128, 256, 4, 40, 3000
    sig = (rng.standard_normal(dc * stride + n * B + 4096) * 0.2).astype(np.float32)
    means = np.convolve(sig, np.ones(B) / B, mode="valid").astype(np.float32)
    ext = np.zeros(stride + len(means) + 1024, np.float32)
    ext[stride : stride + len(means)] = means
    lobes = rng.integers(-1, dc + 2, M).astype(np.int32)  # -1 and past-the-end lobes
    ranges = (rng.standard_normal((M, n)) * 1.5).astype(np.float32)
    args = (torch.from_numpy(ext).to(dev), torch.from_numpy(lobes).to(dev),
            torch.from_numpy(ranges).to(dev), dc * stride - 700, stride, B,
            objective, 2.0)
    s_k, i_k = kernels.refine_window(*args)
    s_p, i_p = kernels.refine_window_ref(*args)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)


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
    run's records (the plain versions are the kernels' arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sig = bench.make_signal(2.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, device="cuda")
    assert kernels.LAUNCHES == {"search_scan": 1, "topc_scan": 0, "refine_window": 1}
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


@pytest.mark.parametrize("objective", ["balanced", "affine", "damped"])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("N,ties", [(4, False), (4, True), (7, False)])
def test_topc_scan_kernel_equals_plain(dev, objective, C, N, ties):
    r_c, bankT, w, valid, t, c = _k3(dev, 11 * C + N, 3000, 5000, N, objective, ties)
    before = kernels.LAUNCHES["topc_scan"]
    got = kernels.topc_scan(r_c, bankT, w, valid, C, t, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topc_scan"] == before + 1
    want = kernels.topc_scan_ref(r_c, bankT, w, valid, C, t, c)
    assert torch.equal(got, want)


def test_topc_scan_kernel_unfilled_and_all_invalid(dev):
    r_c, bankT, w, valid, t, c = _k1(dev, 3, 700, 900, 4, "damped")
    few = torch.zeros_like(valid)
    few[[3, 400]] = True  # two valid domains for C = 4: the rest is -1
    for v in (few, torch.zeros_like(valid)):
        got = kernels.topc_scan(r_c, bankT, w, v, 4, t, c)
        assert torch.equal(got, kernels.topc_scan_ref(r_c, bankT, w, v, 4, t, c))
        assert (got[:, int(v.sum()) :] == -1).all() and (got[:, : int(v.sum())] >= 0).all()


def test_damped_slice_on_the_card_matches_the_host():
    """The 2 s damped slice on the card runs K3 once and K2 once per lobe
    and gives the host run's records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sig = bench.make_signal(2.0)
    kernels.reset_launch_counts()
    gpu = port.compress_audio_arrays(sig, 44100, 2, objective="damped", device="cuda")
    assert kernels.LAUNCHES == {"search_scan": 0, "topc_scan": 1, "refine_window": 4}
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
