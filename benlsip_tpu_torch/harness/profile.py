"""Profiling hook (PyTorch port of `benlsip_tpu/harness/profile.py`): a
torch.profiler trace of a block, written as a Chrome trace with the span
recorder's spans (`_trace`) beside the profiler's events."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity

from .. import _trace
from .._device import resolve_device

# Thread ids of the spans' two tracks in the Chrome trace.
HOST_TRACK, DEVICE_TRACK = 1_000_000_001, 1_000_000_002


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block and write `trace-<pid>-<ns>.json` (Chrome
    trace format) to `log_dir`; yields the profiler, whose
    `key_averages()` sum the events.

    On the card (`device=None`, or a CUDA device) only device activity is
    recorded: with the host's events as well, a trace of a 1,024-instance
    solve took minutes on an H100's host.  On the CPU (`device="cpu"`) the host's operators
    are recorded.

    The span recorder is on for the block (and off after it, if it was
    off before): the spans opened in the block go into the same file on two
    tracks of their own, "spans: host" and "spans: device" (the device
    spans' CUDA events on the host's clock), so the stages inside CUDA-graph
    replays, which the profiler does not see, show beside its events."""
    dev = resolve_device(device)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    os.makedirs(log_dir, exist_ok=True)
    was_on = _trace.ON
    _trace.enable(dev)
    t_start, n_setup = time.perf_counter_ns(), len(_trace.setup_spans())
    try:
        with torch.profiler.profile(activities=[activity]) as prof:
            yield prof
        spans = [s for s in _trace.spans() if s.t0 >= t_start] + _trace.setup_spans()[n_setup:]
    finally:
        if not was_on:
            _trace.disable()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += chrome_events(spans, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


def chrome_events(spans: list, base_ns: int = 0) -> list:
    """Chrome trace events ("X", µs) of recorded spans: host spans on one
    track, device spans on another.  The profiler's timestamps are
    microseconds of the wall clock after `base_ns`; a span's are
    `time.perf_counter_ns()`, moved by the two clocks' offset now."""
    pid = os.getpid()
    shift = time.time_ns() - time.perf_counter_ns() - base_ns
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
              for tid, name in ((HOST_TRACK, "spans: host"), (DEVICE_TRACK, "spans: device"))]
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "call": s.call, **(s.attrs or {})}
        for tid, interval in ((HOST_TRACK, (s.t0, s.t1)), (DEVICE_TRACK, s.device)):
            if interval is None or interval[1] is None:
                continue
            events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
                           "ts": (interval[0] + shift) / 1e3, "dur": (interval[1] - interval[0]) / 1e3, "args": args})
    return events
