"""The stream's input build per request (ms): the phase `shard_prep`
(models/stream.py: each shard's window and packed VAD bits, the pass's
whole file and its shard-local rows)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("shard_prep"))
