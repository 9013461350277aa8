"""The signal's preparation for the device per request (ms): the phase
`prep` (models/encode.py _prep_signal: the buckets, the padded copy, the
int16 probe; models/stream.py: the silence test, the whole-file pads, the
int16 probe)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("prep"))
