"""cert_graph_ms_per_call (ms/call, layer: the f64 certification): the
device time of the `cert` spans (`benlsip_tpu_torch._trace`: CUDA events
around the certification graph's replay, on the host's clock) over the
window, per call.  On the CPU the stages run as plain calls, and a span's
device time is its host time.  Nothing to read without the recorder."""
from portbench import spans


def before_window(run):
    spans.start(run)


def read(run):
    split = spans.breakdown(run)
    return None if split is None else float(split["device_ms"].get("cert", 0.0))
