"""al_outer_iters_per_lane (iters/lane, layer: the f32 bulk): the bulk's
outer augmented-Lagrangian iterations, multiplier updates and penalty
raises together, summed over the window's lanes on the device inside the
bulk graph (`fused_small.replay_counts()["al_outer_iters"]`, read once
after the window), per lane.  Counted by pipelines with nonlinear
constraints only; nothing to read elsewhere, or in a port without the
counter."""
from benlsip_tpu_torch.batch import fused_small


def before_window(run):
    fused_small.reset_replay_counts()


def read(run):
    c = fused_small.replay_counts()
    if "al_outer_iters" not in c:
        return None
    return c["al_outer_iters"] / (run.n_calls * run.mix["batch"])
