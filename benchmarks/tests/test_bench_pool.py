"""The traffic generator: a pool and an order are functions of the seed."""

import itertools

import numpy as np

from benchmarks import pool


def test_same_seed_same_pool(tiny_mix):
    seed = 2**31 + 977
    a, b = pool.build(tiny_mix, 44100, seed), pool.build(tiny_mix, 44100, seed)
    assert [f.params for f in a] == [f.params for f in b]
    for fa, fb in zip(a, b):
        assert np.array_equal(fa.samples, fb.samples)
    oa = list(itertools.islice(pool.order(3, seed), 30))
    assert oa == list(itertools.islice(pool.order(3, seed), 30))


def test_other_seed_same_lengths_other_content(tiny_mix):
    a, b = pool.build(tiny_mix, 44100, 5), pool.build(tiny_mix, 44100, 6)
    assert [len(f.samples) for f in a] == [len(f.samples) for f in b]
    assert not np.array_equal(a[0].samples, b[0].samples)


def test_every_pass_sends_every_file_once():
    order = list(itertools.islice(pool.order(7, 123), 7 * 5))
    for k in range(5):
        assert sorted(order[7 * k : 7 * (k + 1)]) == list(range(7))


def test_content_is_int16_with_silence(tiny_mix):
    f = pool.build(tiny_mix, 44100, 99)[-1]
    assert np.array_equal(f.samples, np.round(f.samples))
    assert np.abs(f.samples).max() <= 32767
    assert (f.samples == 0).sum() > 0.1 * 44100


def test_sample_holds_the_longest():
    for seed in range(20):
        picked = pool.sample([0, 1, 2, 3, 4, 5, 5], 4, 3, seed)
        assert 4 in picked and len(picked) == 3


def test_sample_takes_one_file_of_each_group():
    groups = {i: ("key", i // 4) for i in range(12)}
    for seed in range(20):
        picked = pool.sample(list(range(12)), 11, 2, seed, groups)
        assert 11 in picked and len(picked) == 3
        assert {groups[i] for i in picked} == {("key", 0), ("key", 1), ("key", 2)}
    assert pool.sample(list(range(12)), 11, 5, 3, groups) != pool.sample(
        list(range(12)), 11, 5, 4, groups)
    assert len(pool.sample(list(range(12)), 11, 5, 3, groups)) == 5
