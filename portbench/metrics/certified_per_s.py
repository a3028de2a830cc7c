"""certified_per_s (inst/s, host clock): instances the port flagged
certified in all the window's calls, over the window's measured seconds."""


def read(run):
    return sum(int(ok.sum()) for _, _, ok, _, _ in run.calls) / run.window_s
