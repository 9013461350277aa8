"""The warm-up finds the codec's shape keys by its program counters alone:
every pool file is sent until it runs no new key and captures none, and
the window then adds to neither count."""

from types import SimpleNamespace

import numpy as np

from benchmarks import harness


class _Program:
    pool = 0

    def __init__(self, *args):
        pass

    def fill(self, host_inputs):
        pass

    def release(self):
        pass

    def launch(self):
        return None

    def info(self, memory=False):
        return {}


def test_warm_up_settles_every_key(monkeypatch):
    from fwav_tpu_torch.models import program

    cache = program.ProgramCache(make=_Program)
    monkeypatch.setattr(program, "PROGRAMS", cache)
    sent = []

    class Entry:
        """Files 0-6 in three shape keys, by length."""

        def request(self, i):
            sent.append(i)
            cache.load(("len", i // 3), "cpu", (np.zeros(1, np.float32),), lambda x: x).launch()

    files = [SimpleNamespace(index=i) for i in range(7)]
    keys = harness.warm_up(Entry(), files)
    assert keys == {i: ("len", i // 3) for i in range(7)}
    # a key's first file: eager, captured, then a replay; the others replay at once
    assert sent == [0, 0, 0, 1, 2, 3, 3, 3, 4, 5, 6, 6, 6]
    counts = harness.program_counts()
    for f in files:
        Entry().request(f.index)
    assert harness.program_counts() == counts == (3, 3)


def test_warm_up_gives_up_on_a_shape_that_never_settles(monkeypatch):
    from fwav_tpu_torch.models import program

    cache = program.ProgramCache(make=_Program)
    monkeypatch.setattr(program, "PROGRAMS", cache)
    calls = iter(range(100))

    class Entry:
        def request(self, i):
            cache.load(("fresh", next(calls)), "cpu", (np.zeros(1, np.float32),),
                       lambda x: x).launch()

    try:
        harness.warm_up(Entry(), [SimpleNamespace(index=0)])
    except RuntimeError as e:
        assert "new shape" in str(e)
    else:
        raise AssertionError("warm-up did not give up")
