"""One span recorder for the call path (port-only, like `_loops.py`).

A span is one stage of a call: its name, its parent span, the id of the
`solve_mixed_precision` call it belongs to (`call()` opens the root span
and a new id), its start and end on the host's clock
(`time.perf_counter_ns()`), and a few attributes (`rows`, `lanes`,
`stage`).  The spans sit at the layer boundaries of the timed entry:

* `call` — `batch/refine.solve_mixed_precision`;
* `load`, `bulk` (one a chunk), `cert` — `batch/fused_small`: the data
  copied into the key's buffers, each bulk graph's replay, the
  certification graph's replay;
* `finish` — `batch/polish.finish_polish` with its one host sync, and
  inside it `fallback` (`fallback_full_refine`) with a `refine` child for
  each round of `refine_f64`;
* `bulk`, `certify` — the plain and the overlapped routes of
  `batch/refine` (the overlap's `certify` spans run on its worker thread,
  under the call's root span).

The recorder is off by default: `enable()`, `disable()`, `reset()`, and
`spans()` hands out what it recorded.  While it is off a span site costs
one test of the module global `ON`: `span()` and `call()` return a shared
no-op context, and no event or span is made.  While it is on, nothing is
written anywhere: the spans stay in memory until `reset()`.

`load`, `bulk` and `cert` are device spans: on a CUDA device they also
take a pair of timing events from a pool, recorded on the current stream
around the work.  The events go onto the host's clock by an anchor taken
at `enable()` (the host's clock read, an anchor event recorded, a sync,
the clock read again: the anchor is the midpoint, half the difference its
stated uncertainty) and a second anchor taken where the spans are read,
which gives the rate of one clock against the other.  Events are read
(and go back to the pool) when a device span opens while the device is
still busy with the last one (the fused route's `cert`, opened while the
bulk graph runs): the host's reading then overlaps the device's work and
adds nothing to the call's critical path.  The earlier calls' events are
complete by then, as each call's own sync in `finish_polish` has
returned; one still running waits for a later reading.  `spans()` reads
the rest.  The recorder adds no sync to the call path and no
`_loops.HOST_SYNCS` count.  No event is recorded while a
stream is capturing, outside eager loop mode, or under a set-up span: such
a span is timed on the host only.  On the CPU the stages run as plain
calls inside their spans, so a device span there has no events and its
device interval is its host interval.

Set-up spans (`setup_span`: `library_load` for the kernel library's first
load, `warmup` for a pipeline's eager run before its captures, `capture`
for each graph captured) are recorded whether or not the recorder is on,
once per cache key as `batch/fused_small.GRAPH_STATS` is, into a list of
their own (`setup_spans()`) that `reset()` leaves alone.

`attribute(spans)` splits a window of spans into the device's busy time
by span name and its idle time by the host span open over it.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

import torch

from . import _loops
from .kernels import batched_linalg as _kern

ON = False
_SPANS: list = []       # call-path spans since the last reset(), in the order they opened
_SETUP: list = []       # set-up spans since the process began
_PENDING: list = []     # device spans whose events are not resolved yet
_POOL: list = []        # timing events free for reuse
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)
_LOCAL = threading.local()    # .stack: the spans open on this thread
_CLOCK: Optional["Clock"] = None
_call: Optional["Span"] = None   # the open root span: the parent of a span opened on a worker thread


class Clock:
    """A device's timing events on the host's clock.  The anchor event's
    device time lies between two host readings `lo` and `hi` (ns): it is
    put at their midpoint, and half their difference is the uncertainty.
    `rescale` takes a second anchor, which sets the host's nanoseconds a
    device nanosecond (1 until then)."""

    def __init__(self, lo: float, hi: float, event=None, device: Optional[torch.device] = None):
        self.host, self.half = (lo + hi) / 2, (hi - lo) / 2
        self.rate, self.event, self.device = 1.0, event, device

    def rescale(self, lo: float, hi: float, elapsed_ms: float) -> None:
        """A second anchor, read as (lo, hi) on the host and `elapsed_ms`
        after the first on the device."""
        if elapsed_ms > 0:
            self.rate = ((lo + hi) / 2 - self.host) / (elapsed_ms * 1e6)
        self.half = max(self.half, (hi - lo) / 2)

    def to_host(self, offset_ms: float) -> float:
        """The host time (ns) of a device time `offset_ms` after the anchor."""
        return self.host + offset_ms * 1e6 * self.rate


def _anchor(device: torch.device):
    """(lo, the anchor event, hi) on `device`: off the call path, it syncs."""
    torch.cuda.synchronize(device)
    event = torch.cuda.Event(enable_timing=True)
    lo = time.perf_counter_ns()
    event.record(torch.cuda.current_stream(device))
    torch.cuda.synchronize(device)
    return lo, event, time.perf_counter_ns()


class Span:
    """One recorded span, and the context manager that closes it: `name`,
    `id`, the `parent` span's id (None at a root), the `call` id, `t0` and
    `t1` (host ns; `t1` None while open), `attrs` (None or a dict), and
    `device`, the interval of its device work on the host's clock.
    `host_only`: opened under a set-up span, so it records no event;
    `sync`: a device span on the CPU, whose work is its host interval."""

    __slots__ = ("name", "id", "parent", "call", "t0", "t1", "attrs", "host_only", "sync",
                 "_events", "_stream", "_clock", "_offsets", "_outer", "d0", "d1")

    def __init__(self, name: str, parent: Optional["Span"], call, attrs: Optional[dict], setup: bool):
        self.name, self.id, self.attrs = name, next(_IDS), attrs
        self.parent = parent.id if parent is not None else None
        self.call = call
        self.host_only = setup or (parent is not None and parent.host_only)
        self.sync = False
        self._events = self._stream = self._clock = self._offsets = self._outer = None
        self.d0 = self.d1 = None
        self.t1 = None
        self.t0 = time.perf_counter_ns()

    @property
    def device(self):
        """(start, end) of the span's device work on the host's clock (ns),
        or None for a host span."""
        if self.d0 is not None:
            return self.d0, self.d1
        return (self.t0, self.t1) if self.sync else None

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        _close(self)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, attrs={self.attrs})"


class _Null:
    """The span of a site while the recorder is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _open(name: str, device, attrs: Optional[dict], *, setup: bool = False, new_call: bool = False) -> Span:
    global _call
    stack = _stack()
    parent = stack[-1] if stack else _call
    call = next(_CALL_IDS) if new_call else (parent.call if parent is not None else None)
    sp = Span(name, parent, call, attrs, setup)
    if device is not None and not sp.host_only:
        if device.type != "cuda":
            sp.sync = True
        elif (_CLOCK is not None and _CLOCK.device == device and _loops.current_mode() == "eager"
              and not torch.cuda.is_current_stream_capturing()):
            if _PENDING and not _PENDING[-1]._events[1].query():
                # The device is busy with an earlier span: read the events
                # that are complete meanwhile, off the critical path.
                _resolve(wait=False)
            sp._events, sp._clock = (_event(), _event()), _CLOCK
            sp._stream = torch.cuda.current_stream(device)
            sp._events[0].record(sp._stream)
    stack.append(sp)
    if new_call:
        sp._outer, _call = _call, sp     # the enclosing root, put back at close
    (_SETUP if setup else _SPANS).append(sp)
    return sp


def _close(sp: Span) -> None:
    global _call
    if sp._events is not None:
        sp._events[1].record(sp._stream)
        with _LOCK:
            _PENDING.append(sp)
    sp.t1 = time.perf_counter_ns()
    _stack().pop()                         # spans close in the order they opened, on their thread
    if sp.name == "call" and _call is sp:
        _call, sp._outer = sp._outer, None


def _event():
    with _LOCK:
        if _POOL:
            return _POOL.pop()
    return torch.cuda.Event(enable_timing=True)


def _resolve(wait: bool) -> None:
    """Device offsets (ms after the anchor) of the pending spans whose
    events are complete, or of all of them where `wait`; their events go
    back to the pool."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    keep = []
    for sp in pending:
        start, end = sp._events
        if not end.query():
            if not wait:
                keep.append(sp)
                continue
            end.synchronize()
        anchor = sp._clock.event
        sp._offsets = (anchor.elapsed_time(start), anchor.elapsed_time(end))
        sp._events = sp._stream = None
        with _LOCK:
            _POOL.extend((start, end))
    with _LOCK:
        _PENDING[:0] = keep


def span(name: str, device=None, *, rows: Optional[int] = None, lanes: Optional[int] = None):
    """A span of the call path, used as `with span(...)`: host-timed, and a
    device span where `device` is given.  The shared no-op while off."""
    if not ON:
        return _NULL
    attrs = {k: v for k, v in (("rows", rows), ("lanes", lanes)) if v is not None} or None
    return _open(name, device, attrs)


def call(*, rows: Optional[int] = None):
    """The root span of one call, with a new call id.  The no-op while
    off."""
    if not ON:
        return _NULL
    return _open("call", None, {"rows": rows} if rows is not None else None, new_call=True)


def setup_span(name: str, *, stage: Optional[str] = None) -> Span:
    """A set-up span, host-timed and recorded whether or not the recorder
    is on; no device span opens under it."""
    return _open(name, None, {"stage": stage} if stage is not None else None, setup=True)


_kern.set_load_span(lambda: setup_span("library_load"))


def enable(device=None) -> None:
    """Turn the recorder on, anchoring `device`'s timing events (default:
    the current CUDA device, where there is one) to the host's clock."""
    global ON, _CLOCK
    if ON:
        return
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    device = None if device is None else torch.device(device)
    _CLOCK = None          # a clock, and its pool of events, belong to one enable(); spans keep theirs
    with _LOCK:
        del _POOL[:]
    if device is not None and device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        lo, event, hi = _anchor(device)
        _CLOCK = Clock(lo, hi, event, device)
    ON = True


def _rescale() -> None:
    if _CLOCK is not None and _CLOCK.event is not None:
        lo, event, hi = _anchor(_CLOCK.device)
        _CLOCK.rescale(lo, hi, _CLOCK.event.elapsed_time(event))


def disable() -> None:
    """Turn the recorder off; what it recorded stays until `reset()`."""
    global ON
    if ON:
        ON = False
        _resolve(wait=True)
        _rescale()


def reset() -> None:
    """Drop the call-path spans recorded so far (the set-up spans stay)."""
    _resolve(wait=True)
    del _SPANS[:]


def clock() -> Optional[Clock]:
    """The anchor of the device spans (None without a CUDA device)."""
    return _CLOCK


def spans() -> list:
    """The call-path spans since the last `reset()` (closed or still open),
    their device intervals on the host's clock.  Syncs where device spans
    are pending: call it off the call path."""
    _resolve(wait=True)
    out = list(_SPANS)
    if ON and any(sp._clock is not None for sp in out):
        _rescale()
    for sp in out:
        if sp._offsets is not None:
            sp.d0, sp.d1 = sp._clock.to_host(sp._offsets[0]), sp._clock.to_host(sp._offsets[1])
    return out


def setup_spans() -> list:
    """The set-up spans since the process began."""
    return list(_SETUP)


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def attribute(spans: list) -> dict:
    """Where the window of a list of call-path spans went, per call.

    The window runs from the first `call` span's start to the last one's
    end.  The union of the spans' device intervals, clipped to the window,
    is the device's busy time; its complement in the window is the idle
    time.  Each idle stretch is put
    down to the innermost span open on the host over it (the deepest in the
    span tree, the latest opened among equals), split by the length of
    overlap; where no span is open (between calls) it is the `caller`'s.

    Returns {"calls", "window_ms", "busy_ms", "idle_ms" (totals),
    "device_ms": {span name: device ms a call}, "idle_by": {host span name:
    idle ms a call}, "gaps": the ten longest idle stretches as (ms, the
    span that holds most of it, its start in ms into the window)}."""
    roots = [s for s in spans if s.name == "call" and s.t1 is not None]
    lo, hi = (min(s.t0 for s in roots), max(s.t1 for s in roots)) if roots else (0, 0)
    per = 1.0 / max(len(roots), 1)

    device_ms = collections.Counter()
    busy = []
    for s in spans:
        d = s.device
        if d is None or d[1] is None:
            continue
        a, b = max(d[0], lo), min(d[1], hi)
        if b > a:
            device_ms[s.name] += (b - a) / 1e6 * per
            busy.append((a, b))
    busy = _union(busy)
    idle, t = [], lo
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if hi > t:
        idle.append((t, hi))

    by_id = {s.id: s for s in spans}
    depth = {}

    def depth_of(s) -> int:
        if s.id not in depth:
            parent = by_id.get(s.parent)
            depth[s.id] = 0 if parent is None else depth_of(parent) + 1
        return depth[s.id]

    events = []
    for s in spans:
        a, b = max(s.t0, lo), min(hi if s.t1 is None else s.t1, hi)
        if b > a:
            events += [(a, 1, s.id), (b, 0, s.id)]
    events.sort()
    active, j = {}, 0
    idle_by, gaps = collections.Counter(), []

    def advance(to) -> None:
        nonlocal j
        while j < len(events) and events[j][0] <= to:
            t_ev, opens, sid = events[j]
            if opens:
                active[sid] = by_id[sid]
            else:
                active.pop(sid, None)
            j += 1

    def innermost() -> str:
        if not active:
            return "caller"
        return max(active.values(), key=lambda s: (depth_of(s), s.t0)).name

    for a, b in idle:
        pieces = collections.Counter()
        t = a
        advance(t)
        while t < b:
            end = min(b, events[j][0]) if j < len(events) else b
            if end > t:
                pieces[innermost()] += end - t
            t = end
            advance(t)
        idle_by.update({k: v / 1e6 * per for k, v in pieces.items()})
        gaps.append(((b - a) / 1e6, pieces.most_common(1)[0][0], (a - lo) / 1e6))
    gaps.sort(key=lambda g: -g[0])
    busy_ms = sum(b - a for a, b in busy) / 1e6
    return {"calls": len(roots), "window_ms": (hi - lo) / 1e6, "busy_ms": busy_ms,
            "idle_ms": (hi - lo) / 1e6 - busy_ms, "device_ms": dict(device_ms), "idle_by": dict(idle_by),
            "gaps": gaps[:10]}
