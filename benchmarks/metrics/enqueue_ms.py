"""Enqueue of the captured program per request (ms): the phase `device`
less its `d2h` (models/program.py: the pinned copies and the graph
launch; the eager program where no graph is captured)."""


def read(run):
    return run.phase_ms(lambda ph: ph["device"] - ph["d2h"] if "device" in ph and "d2h" in ph
                        else None)
