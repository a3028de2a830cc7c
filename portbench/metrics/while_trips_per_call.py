"""while_trips_per_call (layer: the f32 bulk): the trips of every WHILE
node that the graph replays ran over the window
(`fused_small.replay_counts()["loop_trips"]`), per call.  The bulk's loops
make nearly all of them; the certification graph's few loops count too."""
from benlsip_tpu_torch.batch import fused_small


def before_window(run):
    fused_small.reset_replay_counts()


def read(run):
    c = fused_small.replay_counts()
    if c["replays"] == 0:
        return None
    return c["loop_trips"] / run.n_calls
