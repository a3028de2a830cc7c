"""capture_s (s, layer: graphs): the seconds that capturing and
instantiating the cell's graphs took at set-up
(`fused_small.GRAPH_STATS`).  Nothing to read where nothing was captured."""
from benlsip_tpu_torch.batch import fused_small


def before_window(run):
    run.state["capture_s"] = sum(g["capture_s"] + g["instantiate_s"] for g in fused_small.GRAPH_STATS)
    run.state["graphs"] = len(fused_small.GRAPH_STATS)


def read(run):
    return run.state["capture_s"] if run.state["graphs"] else None
