"""The damped stream's refit of the global pass's winners per request
(ms): the phase `global_refit` (models/stream.py _global_pass, after
`global_pass`)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("global_refit"))
