"""warmup_s (s, layer: graphs): the seconds of the `warmup` set-up spans
(`benlsip_tpu_torch._trace`, recorded always: the eager run of
`fused_small._Pipeline.capture` before its graphs are captured), 0 where
set-up ran none (the CPU, where the stages run as plain calls).  Nothing
to read without the recorder."""
from portbench import spans


def before_window(run):
    spans.start(run)


def read(run):
    return spans.setup_seconds("warmup")
