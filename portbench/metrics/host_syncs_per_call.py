"""host_syncs_per_call (layer: host loop control, `_loops`): the loop
decisions the host waited for (`_loops.HOST_SYNCS`) over the window, per
call.  A fused call makes one; a lane sent to the eager fallback adds its
loops' trips."""
from benlsip_tpu_torch import _loops


def before_window(run):
    run.state["host_syncs"] = _loops.HOST_SYNCS


def read(run):
    return (_loops.HOST_SYNCS - run.state["host_syncs"]) / run.n_calls
