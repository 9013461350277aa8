"""Share of the traced window in which no kernel, copy or memset ran on
the card (%): 100 (1 - busy / window), from the torch.profiler trace."""


def read(run):
    if run.window is None or run.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.window.busy_s / run.window.window_s)
