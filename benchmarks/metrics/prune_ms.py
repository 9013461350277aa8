"""The prune per request (ms): the phase `prune` (models/encode.py
prune_bank on the single-shot path, models/stream.py _prune_streamed on
the stream)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("prune"))
