"""Profiling hook (PyTorch port of `benlsip_tpu/harness/profile.py`): a
torch.profiler trace of a block, written as a Chrome trace."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity

from .._device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block and write `trace-<pid>-<ns>.json` (Chrome
    trace format) to `log_dir`; yields the profiler, whose
    `key_averages()` sum the events.

    On the card (`device=None`, or a CUDA device) only device activity is
    recorded: with the host's events as well, a trace of a 1,024-instance
    solve took minutes on an H100's host.  On the CPU (`device="cpu"`) the host's operators
    are recorded."""
    dev = resolve_device(device)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=[activity]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
