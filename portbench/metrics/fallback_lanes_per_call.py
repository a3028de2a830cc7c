"""fallback_lanes_per_call (layer: certification, `batch/polish`): lanes
the fused certification left to `fallback_full_refine` (the lanes whose
returned `info.outer_iters` is above 0), per call of the window."""


def read(run):
    return sum(int((outer > 0).sum()) for *_, outer in run.calls) / run.n_calls
