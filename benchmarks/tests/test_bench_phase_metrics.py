"""The readers of the phases of the file API, the stream and the signal's
preparation, and of what no phase covers, on a hand-made Run: each reads
its phase (ms, the mean over the timed requests), nothing where no request
has it, and uncovered_ms reads the wall time less the outermost phases by
the program's phase tree."""

import pytest

from benchmarks import harness
from fwav_tpu_torch.utils.trace import PARENT

#: Two timed requests of a streamed compact file (seconds) and one traced
#: one that the readers leave out.
PHASES = [
    {"wav_read": 0.002, "vad": 0.05, "prep": 0.02, "shard_prep": 0.03, "dispatch": 0.01, "fetch_wait": 0.2,
     "host_refit": 0.25, "global_pass": 0.03, "global_h2d": 0.01, "global_dispatch": 0.01,
     "global_fetch": 0.01, "global_refit": 0.04, "prune": 0.2, "container": 1.5,
     "container_entropy": 0.5, "container_deflate": 0.9, "write": 0.004},
    {"wav_read": 0.004, "vad": 0.05, "prep": 0.04, "shard_prep": 0.01, "dispatch": 0.01, "fetch_wait": 0.2,
     "host_refit": 0.25, "global_pass": 0.03, "global_h2d": 0.01, "global_dispatch": 0.01,
     "global_fetch": 0.01, "global_refit": 0.02, "prune": 0.1, "container": 1.3,
     "container_entropy": 0.5, "container_deflate": 0.7, "write": 0.002},
]
WALL = [2.5, 2.1]


def _run(phases=PHASES, walls=WALL):
    reqs = [harness.Request(0, 10.0 * k, 10.0 * k + w, ph, True, False)
            for k, (ph, w) in enumerate(zip(phases, walls))]
    reqs.append(harness.Request(0, 99.0, 199.0, {"container": 50.0}, True, True))
    return harness.Run(reqs, None, None, [])


@pytest.mark.parametrize("metric, want", [
    ("container_ms", 1400.0),
    ("container_entropy_ms", 500.0),
    ("container_deflate_ms", 800.0),
    ("prune_ms", 150.0),
    ("file_io_ms", 6.0),
    ("shard_prep_ms", 20.0),
    ("global_refit_ms", 30.0),
    ("prep_ms", 30.0),
])
def test_reader_reads_its_phase(metric, want):
    read = harness.find_metric(metric)
    assert read(_run()) == pytest.approx(want)
    assert read(_run([{"device": 0.01}, {"refit": 0.01}])) is None


def test_file_io_without_a_write():
    """v1 has no write of its own: the read alone."""
    run = _run([{"wav_read": 0.003, "container": 0.2}], [0.5])
    assert harness.find_metric("file_io_ms")(run) == pytest.approx(3.0)


def test_uncovered_is_wall_less_the_outermost_phases():
    outer = [sum(t for name, t in ph.items() if name not in PARENT) for ph in PHASES]
    want = 1000.0 * sum(w - o for w, o in zip(WALL, outer)) / len(WALL)
    assert harness.find_metric("uncovered_ms")(_run()) == pytest.approx(want)
    # by hand: the first request's outermost phases sum to 2.336 s, the second's to 2.016 s
    assert want == pytest.approx(1000.0 * ((2.5 - 2.336) + (2.1 - 2.016)) / 2)
    assert harness.find_metric("uncovered_ms")(harness.Run([], None, None, [])) is None


def test_uncovered_counts_a_new_phase_by_the_tree():
    """A phase that PARENT does not name is outermost and counts at once;
    one it names inside another is not counted twice."""
    read = harness.find_metric("uncovered_ms")
    base = read(_run([{"device": 0.4, "d2h": 0.3, "host_bank": 0.2}], [1.0]))
    assert base == pytest.approx(600.0)
    assert read(_run([{"device": 0.4, "d2h": 0.3, "prep": 0.1}], [1.0])) == pytest.approx(500.0)


def test_uncovered_is_silent_without_a_phase_tree(monkeypatch):
    """On a program that states no phase tree the reader returns None."""
    import fwav_tpu_torch.utils.trace as trace

    monkeypatch.delattr(trace, "PARENT")
    assert harness.find_metric("uncovered_ms")(_run()) is None
