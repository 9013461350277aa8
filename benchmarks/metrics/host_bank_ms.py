"""Host bank build per request (ms): the phase `host_bank`, the numpy
bank of the file built while the card runs (models/encode.py
_encode_stack, ops/domains.build_domains_host)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("host_bank"))
