"""Host refit of a streamed file's shards per request (ms): the phase
`host_refit` summed over the shards (models/stream.py _refit_shard)."""


def read(run):
    return run.phase_ms(lambda ph: ph.get("host_refit"))
