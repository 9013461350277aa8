"""The damped stream's whole-file global pass per request (ms): the phase
`global_pass` (models/stream.py _global_pass: its copy, enqueue and the
wait for its winners)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("global_pass"))
