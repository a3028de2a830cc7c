"""The port's span recorder (`benlsip_tpu_torch._trace`) read over a traced
window, for the readers of bulk_graph_ms_per_call, cert_graph_ms_per_call,
host_gap_ms_per_call and warmup_s.

`start(run)`, each reader's `before_window`, turns the recorder on (only
a `--trace 1` run loads the per-layer readers, so only it does) and drops
what it held.  `breakdown(run)` splits the window once, by
`_trace.attribute`: the device's busy time by span name and its idle time
by the host span open over it, per call, from the first `call` span's
start to the last one's end (the time between calls falls to `caller`).
It checks that the recorder saw each of the window's calls, and prints
the split to stderr, where busy and idle time together are set beside
the harness's `window_s`, and the set-up spans on a timeline from the
process's start.  A port without the recorder has nothing to read: the
readers return None there.
"""
import sys
import time

try:
    from benlsip_tpu_torch import _trace
except ImportError:      # a port without the span recorder
    _trace = None

# Set-up spans, in the order set-up runs them.
SETUP = ("library_load", "warmup", "capture")


def start(run) -> None:
    if _trace is not None:
        # Set-up ended just before the first reader's hook: the set-up
        # spans go on a timeline from the process's start.
        run.state.setdefault("setup_end_ns", time.perf_counter_ns())
        _trace.enable()
        _trace.reset()


def setup_seconds(name: str):
    """Seconds of the set-up spans called `name` (None without the recorder)."""
    if _trace is None:
        return None
    return sum(s.t1 - s.t0 for s in _trace.setup_spans() if s.name == name and s.t1 is not None) / 1e9


def breakdown(run):
    """The window's split (`_trace.attribute`), computed and printed once a
    run; None without the recorder."""
    if _trace is None:
        return None
    if "spans" not in run.state:
        spans = _trace.spans()
        calls = [s for s in spans if s.name == "call"]
        if len(calls) != run.n_calls:
            raise RuntimeError(f"portbench: the span recorder saw {len(calls)} calls in a window of {run.n_calls}")
        split = _trace.attribute(spans)
        run.state["spans"] = split
        _print(run, split, spans)
    return run.state["spans"]


def _print(run, split: dict, spans: list, log=sys.stderr) -> None:
    n, window = split["calls"], split["window_ms"]
    pct = lambda ms: 100.0 * ms * n / window
    clock = _trace.clock()
    anchor = ("no device clock" if clock is None or clock.event is None else
              f"anchor ±{clock.half / 1e3!r} us, host/device clock rate {clock.rate!r}")
    print(f"spans: {n} calls, {len(spans)} spans over {window / 1e3!r} s from the first call's start to the "
          f"last one's end; {anchor}", file=log)
    dev = ", ".join(f"{k} {v!r} ms ({pct(v)!r}%)" for k, v in sorted(split["device_ms"].items(), key=lambda kv: -kv[1]))
    print(f"spans: device ms a call by span: {dev}; busy {split['busy_ms'] / n!r} ms a call "
          f"({100.0 * split['busy_ms'] / window!r}% of the window)", file=log)
    idle = ", ".join(f"{k} {v!r}" for k, v in sorted(split["idle_by"].items(), key=lambda kv: -kv[1]))
    nvml = "not measured" if run.util is None else f"{100.0 - run.util!r}%"
    print(f"spans: idle ms a call by host span: {idle}; idle {100.0 * split['idle_ms'] / window!r}% of the window "
          f"by the spans, device_idle_pct (NVML) {nvml}", file=log)
    gaps = "; ".join(f"{ms!r} ms under {name} at {at!r} ms" for ms, name, at in split["gaps"])
    print(f"spans: the longest idle gaps: {gaps}", file=log)
    total = split["busy_ms"] + split["idle_ms"]
    print(f"spans: device spans + idle (in calls and caller's) = {total / 1e3!r} s against the harness's "
          f"window_s {run.window_s!r} s ({100.0 * (total / 1e3 - run.window_s) / run.window_s!r}%)", file=log)
    setup = ", ".join(f"{name} {setup_seconds(name)!r} s" for name in SETUP)
    print(f"spans: set-up {run.setup_s!r} s: {setup}", file=log)
    if "setup_end_ns" in run.state:
        t0 = run.state["setup_end_ns"] - run.setup_s * 1e9
        at = lambda ns: f"{(ns - t0) / 1e9:.4f}"
        line = "; ".join(f"{s.name}{'' if s.attrs is None else ' ' + str(s.attrs.get('stage', ''))} "
                         f"{at(s.t0)}-{at(s.t1)}" for s in _trace.setup_spans() if s.t1 is not None and s.t0 >= t0)
        print(f"spans: set-up timeline, s from the process's start: {line}; set-up ends {run.setup_s:.4f}", file=log)
