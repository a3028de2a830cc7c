"""call_p95_ms (ms, host clock): the 95th percentile, by nearest rank,
over every call of the window; a call is timed from its start to the
return of a `torch.cuda.synchronize()` after it."""
import math


def read(run):
    times = sorted(run.times)
    return 1000.0 * times[math.ceil(0.95 * len(times)) - 1]
