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
`any_lane`.

Under `log_loops()` each loop captured records a `LoopRecord` of what one
trip runs, and adds the trips it runs in a replay to a device counter.
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


class LoopRecord(NamedTuple):
    """A loop captured as a WHILE node.  To its entry of the `counters`
    given to `log_loops` every run of the loop in a replay adds its trips.
    What one trip runs, the loops nested in it apart: `launches`, the
    kernel wrappers' launches by name, and `body`, its body graph (a
    cudaGraph_t, whose nodes `kernels.batched_linalg.graph_nodes` counts
    once the capture ends)."""

    launches: dict
    body: int


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


@contextlib.contextmanager
def log_loops(counters: Tensor):
    """Record the loops captured in the enclosed capture: yields the list
    of their `LoopRecord`s (innermost first; the i-th adds its trips to
    `counters[i]`, an int64 device tensor allocated before the capture) and
    a Counter of the launches captured inside any of them."""
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


def _map(fn, *trees):
    """fn over the tensors of NamedTuple carries (nested; None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*[_map(fn, *fields) for fields in zip(*trees)])
    return fn(*trees)


def copy_into(dst: C, src: C) -> C:
    """Write every tensor of carry `src` into the buffers of `dst`."""
    _map(lambda d, s: d.copy_(s), dst, src)
    return dst


def clone(carry: C) -> C:
    return _map(torch.clone, carry)


@contextlib.contextmanager
def _while_node(more: Callable[[], Tensor], device: torch.device):
    """Capture the enclosed work (one trip) into the body of a WHILE node
    that repeats it while the 0-dim bool `more()` holds, tested before the
    first trip and after each (`kernels/csrc/graph_conditional.cu`; torch
    2.11 has no conditional nodes of its own).  The body runs on its
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
    handle, graph = kern.while_begin(more(), torch.cuda.current_stream(dev), body)
    _depth += 1
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
            try:
                yield graph
                kern.while_set(handle, more(), body)
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
    finally:
        _depth -= 1
        kern.while_end(body)


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

    if run.device.type != "cuda":
        raise ValueError(f"capture mode runs on CUDA tensors only, got {run.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("capture mode outside a CUDA graph capture")
    from .kernels import batched_linalg as kern

    carry, run = clone(carry), run.clone()
    trips = torch.zeros((), dtype=torch.int32, device=run.device)
    before = dict(kern.CAPTURED)
    _nested.append(collections.Counter())
    try:
        with _while_node(lambda: run.any() & (trips < trip_cap), run.device) as graph:
            copy_into(carry, sel_tuple(run, body(carry, run), carry))
            run.copy_(run & cond(carry))
            trips.add_(1)
    finally:
        nested = _nested.pop()
    if _log is not None:
        if len(_log) == _counters.numel():
            raise RuntimeError(f"more than {_counters.numel()} loops captured in one graph")
        launches = collections.Counter({k: v - before[k] for k, v in kern.CAPTURED.items()})
        _nested[-1].update(launches)
        _counters[len(_log)].add_(trips)
        _log.append(LoopRecord(dict(launches - nested), graph))
    return carry
