"""device_idle_pct (%, layer: the device): 100 − the mean of NVML's
utilization.gpu (the share of time a kernel ran, which sees the kernels
inside graph bodies) sampled over the traced window (`portbench/nvml.py`).
Nothing to read without a card."""


def read(run):
    return None if run.util is None else 100.0 - run.util
