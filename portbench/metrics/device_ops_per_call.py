"""device_ops_per_call (layer: graphs, `batch/fused_small`): the device
kernels and copies that the graph replays ran over the window
(`fused_small.replay_counts()`, exact: each loop body's nodes times its
trips), per call.  Nothing to read where no graph replayed (the CPU)."""
from benlsip_tpu_torch.batch import fused_small


def before_window(run):
    fused_small.reset_replay_counts()


def read(run):
    c = fused_small.replay_counts()
    if c["replays"] == 0:
        return None
    return (c["device_kernels"] + c["device_copies"]) / run.n_calls
