"""host_gap_ms_per_call (ms/call, layer: the host call path): the time
inside the window's calls when no device span ran, per call
(`benlsip_tpu_torch._trace.attribute`: the complement of the device spans'
union, put down to the innermost host span open over it; the time between
calls is the caller's and not counted).  The split by host span is printed
to stderr.  Nothing to read without the recorder."""
from portbench import spans


def before_window(run):
    spans.start(run)


def read(run):
    split = spans.breakdown(run)
    if split is None:
        return None
    return float(sum(ms for name, ms in split["idle_by"].items() if name != "caller"))
