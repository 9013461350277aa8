"""The v2 writer's entropy variant per request (ms): the phase
`container_entropy` (io/compact.py _entropy_variant: the rANS streams and
the o/s quantization choice), inside `container`."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("container_entropy"))
