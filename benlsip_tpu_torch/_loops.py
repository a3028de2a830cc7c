"""One loop primitive for every masked loop of the solver (port-only, like
`_batched.py`).

The JAX package writes each loop for one instance as a `lax.while_loop`
and lifts it with `vmap`.  The port runs it batch-first over a per-lane
mask `run`: `body(carry, run)` gives every lane a new carry, `sel_tuple`
keeps it for the running lanes only (a lane that is done never moves), and
`run & cond(carry)` drops the lanes that finish.  `masked_while` runs such
a loop in one of three modes, which the caller chooses with `loop_mode`:

* "eager" (the default): `while bool(run.any())`, one host sync per trip,
  each counted in `HOST_SYNCS`; a loop that runs past its `trip_cap`
  (where the other modes would stop it) counts in `CAP_OVERRUNS`;
* "capture" (inside a CUDA graph capture): one trip captured into the
  body of a conditional WHILE node that the device repeats while
  `run.any()` and the trip cap allow — `lax.while_loop` on the card, so
  the host decides nothing and a graph holds each loop body once, not
  unrolled to its cap.  The carry is written in place (`copy_`) into
  buffers allocated before the node, so every trip, and the nodes after
  the loop, read fixed addresses.  A body is captured on a stream of its
  nesting depth, and what it allocates comes from a private memory pool
  of that depth (`_while_node`);
* "all_trips": `trip_cap` trips with no guard, every trip masked — what
  the loop computes if its lanes run to the cap (how the CPU tests show
  that a lane that is done never moves).

`trip_cap` is the loop's own termination bound (an iteration counter that
its predicate caps), so no mode can change an answer; eager mode runs
unbounded, as the JAX `lax.while_loop` does, so `CAP_OVERRUNS` shows a cap
set too small.  Data-dependent branches outside loops go through
`any_lane` (unconditional outside eager mode, results selected per lane)
or, where the branch is costly enough that a graph should skip it when no
lane takes it, through `if_any` / `branch_any`: in capture mode the body
goes into a conditional IF node that the device runs only when a lane
takes the branch.

Under `log_loops()` each loop or branch captured records a `LoopRecord` of
what one trip (one taken branch) runs, and adds the trips it runs in a
replay (1 for a taken branch) to a device counter.  `note` counts an event
of the host's choosing (an operator build) in the capture the same way.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, NamedTuple, Optional, TypeVar

import torch

from ._batched import sel_tuple

Tensor = torch.Tensor
C = TypeVar("C")

MODES = ("eager", "capture", "all_trips")
# Host syncs of loop and branch decisions since the last `reset_host_syncs()`.
HOST_SYNCS = 0
# Eager loops that ran more trips than their `trip_cap`, since the process began.
CAP_OVERRUNS = 0
_SYNCS_LOCK = threading.Lock()
_mode = "eager"
# Conditional bodies being captured, and per (device, nesting depth) the
# stream a body is captured on and the private memory pool it allocates from.
_depth = 0
_BODIES: dict = {}
# Events counted by `note` in captures, by key, since the process began.
NOTED: collections.Counter = collections.Counter()


class LoopRecord(NamedTuple):
    """A loop captured as a WHILE node (`kind` "while") or a branch as an
    IF node ("if").  To its entry of the `counters` given to `log_loops`
    every run of the loop in a replay adds its trips, and every run of the
    branch 1 if it was taken.  What one trip or taken branch runs, the
    nodes nested in it apart: `launches`, the kernel wrappers' launches by
    name and the events `note`d, and `body`, its body graph (a cudaGraph_t,
    whose nodes `kernels.batched_linalg.graph_nodes` counts once the
    capture ends)."""

    launches: dict
    body: int
    kind: str = "while"


# The records of the capture under `log_loops()` and its trip counters, and
# per open body the launches captured inside the loops nested in it.
_log: Optional[list] = None
_counters: Optional[Tensor] = None
_nested: list = []


@contextlib.contextmanager
def loop_mode(mode: str):
    """Run the loops of the enclosed calls in `mode` (one of MODES)."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"loop mode {mode!r}: expected one of {MODES}")
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


def current_mode() -> str:
    return _mode


def reset_host_syncs() -> None:
    global HOST_SYNCS
    HOST_SYNCS = 0


def _count_sync() -> None:
    # The overlapped pipeline certifies on a worker thread while the main
    # thread runs the bulk: the increment must not lose a count.
    global HOST_SYNCS
    with _SYNCS_LOCK:
        HOST_SYNCS += 1


def host_any(mask: Tensor) -> bool:
    """bool(mask.any()) on the host: one counted sync."""
    _count_sync()
    return bool(mask.any())


def host_count(mask: Tensor) -> int:
    """int(mask.sum()) on the host: one counted sync."""
    _count_sync()
    return int(mask.sum())


def host_nonzero(mask: Tensor) -> Tensor:
    """Indices of the true lanes of a (B,) mask, as a CPU tensor: one
    counted sync."""
    _count_sync()
    return torch.nonzero(mask.cpu()).squeeze(-1)


def host_rows(run: Tensor, *columns: Tensor) -> list:
    """The rows (k, *columns) of the lanes in `run`, in lane order, on the
    host as Python floats: one counted sync for the stacked (B, k) table.
    For a log written per trip, which only an eager loop can do: under
    capture or "all_trips" it raises ValueError."""
    if _mode != "eager":
        raise ValueError(f"verbose=True writes its rows from eager loops only, not in loop mode {_mode!r}")
    table = torch.stack([run.to(torch.float64)] + [c.to(torch.float64) for c in columns], dim=-1)
    _count_sync()
    return [row[1:] for row in table.cpu().tolist() if row[0]]


def note(key) -> None:
    """Count one event `key` (an operator build) in the capture under way,
    where the graphs' owner multiplies it by the runs of the part of the
    graph it lies in, as it does launches; outside capture mode nothing."""
    if _mode == "capture":
        NOTED[key] += 1


def captured_counts(since: Optional[collections.Counter] = None) -> collections.Counter:
    """The kernel launches captured and the events noted so far, by name
    and key; with `since`, an earlier reading, what was captured after it."""
    from .kernels import batched_linalg as kern

    counts = collections.Counter(kern.CAPTURED) + NOTED
    if since is not None:
        counts.subtract(since)
        counts = +counts
    return counts


@contextlib.contextmanager
def log_loops(counters: Tensor):
    """Record the loops and branches captured in the enclosed capture:
    yields the list of their `LoopRecord`s (innermost first; the i-th adds
    its trips or taken branches to `counters[i]`, an int64 device tensor
    allocated before the capture) and a Counter of the launches and events
    captured inside any of them."""
    global _log, _counters
    prev = _log, _counters
    _log, _counters = [], counters
    _nested.append(collections.Counter())
    try:
        yield _log, _nested[-1]
    finally:
        _nested.pop()
        _log, _counters = prev


def any_lane(mask: Tensor) -> bool:
    """Whether a branch taken for the lanes of `mask` must run: the host
    asks in eager mode; otherwise it runs unconditionally, and the caller
    selects its results per lane, so the answer is the same either way."""
    return _mode != "eager" or host_any(mask)


@contextlib.contextmanager
def if_any(mask: Tensor):
    """Guard the enclosed branch, taken for the lanes of `mask`: yields
    whether its body must run (`with if_any(m) as taken: if taken: ...`).

    * eager: `host_any(mask)`, one counted sync;
    * capture: True, and the body is captured into a conditional IF node
      that the device runs only when `mask.any()`; the body must write its
      results with `copy_` into buffers made before the node (`branch_any`
      does), since a branch not taken writes nothing.  On its depth's stream
      and pool, as a WHILE body (`_conditional_node`);
    * "all_trips": True, the body runs unconditionally.

    The caller selects the branch's results per lane, so the answer is the
    same in every mode."""
    if _mode == "eager":
        yield host_any(mask)
        return
    if _mode == "all_trips":
        yield True
        return
    _require_capture(mask)
    taken = mask.any()
    before = captured_counts()
    _nested.append(collections.Counter())
    try:
        with _conditional_node("if", lambda: taken, mask.device) as graph:
            yield True
    finally:
        nested = _nested.pop()
    _record("if", graph, before, nested, taken)


def branch_any(mask: Tensor, branch: Callable[[], C], otherwise: C) -> C:
    """`branch()` when a lane of `mask` takes it, else `otherwise`: the
    carry of a branch under `if_any`.  `branch()` selects its results per
    lane against `otherwise` (same structure).  Under capture the results
    are copied into buffers cloned from `otherwise` before the IF node, so
    a replay that skips the branch leaves them equal to `otherwise`."""
    out = clone(otherwise) if _mode == "capture" else otherwise
    with if_any(mask) as taken:
        if taken:
            new = branch()
            out = copy_into(out, new) if _mode == "capture" else new
    return out


def _map(fn, *trees):
    """fn over the tensors of NamedTuple or tuple carries (nested; None
    stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        fields = [_map(fn, *f) for f in zip(*trees)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return fn(*trees)


def copy_into(dst: C, src: C) -> C:
    """Write every tensor of carry `src` into the buffers of `dst`."""
    _map(lambda d, s: d.copy_(s), dst, src)
    return dst


def clone(carry: C) -> C:
    return _map(torch.clone, carry)


@contextlib.contextmanager
def _conditional_node(kind: str, more: Callable[[], Tensor], device: torch.device):
    """Capture the enclosed work into the body of a conditional node:
    "while" repeats it (one trip) while the 0-dim bool `more()` holds,
    tested before the first trip and after each; "if" runs it once if
    `more()` holds before the node (`kernels/csrc/graph_conditional.cu`;
    torch 2.11 has no conditional nodes of its own).  The body runs on its
    depth's stream; its allocations go to its depth's pool, not the
    graph's, since the caching allocator routes a capture's pool by the
    capturing stream, and ending a route ends the first one of its pool.
    Bodies of one depth follow each other in the graph, so they may share
    memory.  Yields the body graph (a cudaGraph_t)."""
    global _depth
    from .kernels import batched_linalg as kern

    dev = device.index if device.index is not None else torch.cuda.current_device()
    if (dev, _depth) not in _BODIES:
        _BODIES[dev, _depth] = (torch.cuda.Stream(device=dev), torch.cuda.graph_pool_handle())
    body, pool = _BODIES[dev, _depth]
    handle, graph = kern.conditional_begin(kind, more(), torch.cuda.current_stream(dev), body)
    _depth += 1
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
            try:
                yield graph
                if kind == "while":
                    kern.while_set(handle, more(), body)
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
    finally:
        _depth -= 1
        kern.body_end(body)


def _require_capture(t: Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"capture mode runs on CUDA tensors only, got {t.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("capture mode outside a CUDA graph capture")


def _record(kind: str, graph: int, before: collections.Counter, nested: collections.Counter, runs: Tensor) -> None:
    """Under `log_loops()`, the `LoopRecord` of a node just captured: what
    its body captured (`captured_counts()` against `before`), less the
    nodes nested in it, and `runs` (its trips, or 1 if the branch was taken)
    added to its counter."""
    if _log is None:
        return
    if len(_log) == _counters.numel():
        raise RuntimeError(f"more than {_counters.numel()} loops and branches captured in one graph")
    launches = captured_counts(since=before)
    _nested[-1].update(launches)
    _counters[len(_log)].add_(runs)
    _log.append(LoopRecord(dict(launches - nested), graph, kind))


def masked_while(cond: Callable[[C], Tensor], body: Callable[[C, Tensor], C], carry: C, run: Tensor,
                 trip_cap: int) -> C:
    """while run.any(): carry = sel_tuple(run, body(carry, run), carry);
    run &= cond(carry) — in the current mode; outside eager mode for at
    most `trip_cap` trips.

    `cond(carry)` is the per-lane loop predicate and `run` the lanes
    running at entry.
    """
    global CAP_OVERRUNS
    if _mode == "eager":
        trips = 0
        while host_any(run):
            carry = sel_tuple(run, body(carry, run), carry)
            run = run & cond(carry)
            trips += 1
        CAP_OVERRUNS += trips > trip_cap
        return carry
    if trip_cap <= 0:
        return carry
    if _mode == "all_trips":
        for _ in range(trip_cap):
            carry = sel_tuple(run, body(carry, run), carry)
            run = run & cond(carry)
        return carry

    _require_capture(run)
    carry, run = clone(carry), run.clone()
    trips = torch.zeros((), dtype=torch.int32, device=run.device)
    before = captured_counts()
    _nested.append(collections.Counter())
    try:
        with _conditional_node("while", lambda: run.any() & (trips < trip_cap), run.device) as graph:
            copy_into(carry, sel_tuple(run, body(carry, run), carry))
            run.copy_(run & cond(carry))
            trips.add_(1)
    finally:
        nested = _nested.pop()
    _record("while", graph, before, nested, trips)
    return carry
