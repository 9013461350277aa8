"""What no phase covers, per request (ms): the request's wall time less
its outermost phases (device, vad, refit and the stream's). In the file
API: the WAV read, the prune, the v2 entropy coder and the write."""


def read(run):
    if not run.timed:
        return None
    return 1000.0 * sum(r.unphased_s() for r in run.timed) / len(run.timed)
