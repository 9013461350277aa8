"""The v2 writer's legacy deflate pricing per request (ms): the phase
`container_deflate` (io/compact.py compact_bytes: the idx-delta probe and
the zlib passes over the byte planes), inside `container`."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("container_deflate"))
