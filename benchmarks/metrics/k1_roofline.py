"""K1's share of its roofline over the traced requests (%): the least
time the calls need by roofline/k1.py over the time its kernels took
in the trace."""


def read(run):
    return run.roofline("k1")
