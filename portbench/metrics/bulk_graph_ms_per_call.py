"""bulk_graph_ms_per_call (ms/call, layer: the f32 bulk): the device time
of the `bulk` spans (`benlsip_tpu_torch._trace`: CUDA events around each
chunk's copy in, graph replay and copy out, on the host's clock) over the
window, per call.  On the CPU the stages run as plain calls, and a span's
device time is its host time.  Nothing to read without the recorder."""
from portbench import spans


def before_window(run):
    spans.start(run)


def read(run):
    split = spans.breakdown(run)
    return None if split is None else float(split["device_ms"].get("bulk", 0.0))
