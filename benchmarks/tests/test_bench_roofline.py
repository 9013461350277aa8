"""The kernels' work counts: functions of a call's own counts and plan
alone, in agreement with chip_smoke.py's shape arithmetic where the two
count the same thing (chip_smoke's numerators are three BF16 products a
tap, the design's split; these count the one product a tap needs)."""

import dataclasses

import pytest
import torch

import chip_smoke
from benchmarks.calls import descent_rows, single_calls, stream_calls
from benchmarks.harness import find_roofline
from benchmarks.reference.encode import Settings

SR = 44100


@pytest.mark.parametrize("seconds,kw,kernels", [
    (0.5, {}, ["k1"]),
    (10.0, {}, ["k1", "k2"]),
    (10.0, {"objective": "damped"}, ["k3", "k2"]),
    (70.0, {}, ["k1", "k4"]),
    (70.0, {"objective": "damped"}, ["k3", "k4"]),
])
def test_calls_follow_the_plan(seconds, kw, kernels):
    calls = single_calls(Settings(**kw), int(seconds * SR))
    assert [c["kernel"] for c in calls] == kernels
    for c in calls:
        flops, nbytes = find_roofline(c["kernel"]).work(c)
        assert flops > 0 and nbytes > 0


def test_counts_depend_only_on_the_call():
    c = dict(kernel="k1", M=1000, N=4, D=300, C=1, clip=False)
    assert find_roofline("k1").work(c) == find_roofline("k1").work(dict(c))
    a = single_calls(Settings(), 441000)
    assert a == single_calls(Settings(), 441000)
    assert a != single_calls(Settings(), 441000 + 4096)


@pytest.mark.parametrize("M,N,D,clip", [(110250, 4, 3445, False), (110250, 4, 3445, True),
                                        (7000, 32, 900, False)])
def test_scan_agrees_with_chip_smoke(M, N, D, clip):
    flops, nbytes = find_roofline("k1").work(dict(M=M, N=N, D=D, clip=clip))
    b = chip_smoke.scan_bound(M, N, D, D, 8, clip)["bound_terms_ms"]
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(b["bytes"], rel=1e-12)
    assert 3 * flops / chip_smoke.BF16_FLOP_PER_S * 1e3 == pytest.approx(b["tensor"], rel=1e-12)


def test_refine_agrees_with_chip_smoke():
    M, N, C, stride, L = 5000, 4, 4, 128, 60000
    lobes = torch.arange(M * C).reshape(M, C) % 400
    b = chip_smoke.refine_bound(lobes, N, L, "damped", stride)
    flops, nbytes = find_roofline("k2").work(dict(M=M, N=N, C=C, W=stride + stride // 4, L=L))
    assert b["pairs"] == M * C * (stride + stride // 4)
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        b["bound_terms_ms"]["bytes"], rel=1e-12)


@pytest.mark.parametrize("stride,C", [(128, 1), (64, 1), (16, 1), (128, 4), (64, 4)])
def test_staged_rows_agree_with_chip_smoke(stride, C):
    M, nv = 3000, 10**6
    lobes = (torch.arange(M * C).reshape(M, C) * 37) % (nv // stride - 10)
    W = max(2, stride + stride // 4)
    R = descent_rows(W) if stride >= 32 and C == 1 else C * W
    assert chip_smoke.k4_rows(lobes, torch.tensor([nv]), stride, False) == M * R


def test_settings_match_the_codec_defaults():
    from fwav_tpu_torch.config import EncoderConfig

    mine = dataclasses.asdict(Settings())
    theirs = dataclasses.asdict(EncoderConfig())
    assert {k: theirs[k] for k in mine} == mine


def test_stream_calls_and_pass_rows():
    """A 110 s damped stream: K3 and K2 per shard, then the pass's K3 and
    K4, whose rows (each lobe column's descent) agree with chip_smoke's
    count of the same pass."""
    calls = stream_calls(Settings(objective="damped"), 110 * SR)
    kinds = [c["kernel"] for c in calls]
    assert kinds[-2:] == ["k3", "k4"] and kinds[:-2] == ["k3", "k2"] * (len(kinds) // 2 - 1)
    k4 = calls[-1]
    lobes = (torch.arange(3000 * 4).reshape(3000, 4) * 37) % 9000
    assert chip_smoke.k4_rows(lobes, torch.tensor([k4["D"]]), 512, True) == 3000 * k4["R"]
