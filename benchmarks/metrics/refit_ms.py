"""Host refit per request (ms): the phase `refit`, the exact refit of the
selections against the host bank (models/encode.py _finalize_encode, the
native fwav_collect)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("refit"))
