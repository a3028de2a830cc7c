"""polish_straggler_lanes_per_call (lanes/call, layer: the f64
certification): the lanes that the certification graph's first polish
round leaves uncertified, for its straggler passes, summed on the device
inside the graph (`fused_small.replay_counts()["polish_stragglers"]`,
read once after the window), per call.  Counted by pipelines with
nonlinear constraints only; nothing to read elsewhere, or in a port
without the counter."""
from benlsip_tpu_torch.batch import fused_small


def before_window(run):
    fused_small.reset_replay_counts()


def read(run):
    c = fused_small.replay_counts()
    if "polish_stragglers" not in c:
        return None
    return c["polish_stragglers"] / run.n_calls
