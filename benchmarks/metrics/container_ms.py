"""The container's bytes per request (ms): the phase `container`, the v2
writer (io/compact.py compact_bytes) with its two variants inside it; on
v1 the whole native save."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("container"))
