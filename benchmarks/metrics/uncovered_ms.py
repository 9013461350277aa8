"""What no phase covers, per request (ms): the request's wall time less
its outermost phases, those that the program's phase tree
(fwav_tpu_torch.utils.trace.PARENT) puts inside no other. A phase the
program adds counts here as soon as it runs. None where the program
states no phase tree."""


def read(run):
    try:
        from fwav_tpu_torch.utils.trace import PARENT
    except ImportError:
        return None
    if not run.timed:
        return None
    return 1000.0 * sum(r.wall_s - sum(t for name, t in r.phases.items() if name not in PARENT)
                        for r in run.timed) / len(run.timed)
