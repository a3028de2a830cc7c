"""Whole-pipeline fusion for small-instance families (PyTorch port of
`benlsip_tpu/batch/fused_small.py`): from the f32 bulk to certified f64
results as replays of CUDA graphs.

The JAX module stages the whole pipeline as one jitted program whose loops
are `lax.while_loop`s.  The card's counterpart is a CUDA graph whose loops
are conditional WHILE nodes (`_loops.masked_while` in capture mode): each
loop body is captured once, the device repeats it while a lane runs, and
the host decides nothing inside a replay.  The pipeline is two graphs,
each captured at the first call of its key and replayed after:

* `bulk`: the f32 solve of one chunk (`solver/outer.outer_init`, then the
  outer loop), replayed once per chunk of that size;
* `cert`: the certification of the whole batch (`polish.FusedPolish`:
  f32 QR factors, f64 chord steps, exact-projection certificate, then at
  most ⌈B / bucket⌉·(rounds − 1) static straggler passes).  With
  nonlinear constraints (p > 0) the bulk's multipliers Y go to the
  certification too, for the first factor step's curvature term.

Each graph reads its inputs from, and writes its results to, buffers that
live as long as its key; a call copies its data in (cast to f32 or f64 in
the copy) and the results out, and syncs once, to ask whether every lane
is certified.  Lanes the certification leaves
uncertified go to the shared `fallback_full_refine`, outside any graph,
as the JAX fallback stays outside its program.

A bulk that materializes the Gauss-Newton operator (config 3's
CholeskyQR2, n ≥ 64 with a tall Jacobian) captures its builds too: the
rebuild on acceptance and the explicit rescue pass of `ops/qr` sit behind
conditional IF nodes (`_loops.branch_any`), so a replay runs them only
when a lane needs them, and the Cholesky shift rescue selects per lane.

`replay_counts()` says what the replays ran: each WHILE body's captured
kernel launches and device operations times the trips its loop ran, each
IF body's times the replays that took it (a device counter per node),
plus each graph's top level once a replay.

On a CPU tensor the same stages run as plain calls in the current loop
mode: "eager" by default, "all_trips" to compute what the graphs compute
with no guard skipping (`_loops`).

Spans (`_trace`, while the recorder is on): `load` around the casts and
the copies into the key's buffers, `bulk` (attribute `rows`) around each
chunk's copy in, replay and copy out, and `cert` around the certification
graph's replay, each a device span timed by a pair of CUDA events on the
current stream; `finish` is `polish.finish_polish`'s.  The set-up spans
are recorded always, once per cache key: `warmup` around the eager run
of `_Pipeline.capture`, and `capture` (attribute `stage`) around each
stage's capture and instantiation, whose two parts `GRAPH_STATS` keeps.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Tuple

import torch

from .. import _loops, _trace
from .._batched import tree_map
from ..kernels import batched_linalg as kern
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, default_atol, final_multipliers, outer_done, outer_init, outer_loop
from .polish import FusedPolish, PolishState, _check_fallback_pad, finish_polish
from .vmap_solve import BatchedProblem, map_poly_fields

Tensor = torch.Tensor
_POLY_FIELDS = ("A", "b", "xl", "xu")
# Capture and instantiate seconds and captured kernel launches of every
# graph built since the last `reset_graph_stats()`, by stage name.
GRAPH_STATS: list = []
# Whether a pipeline on a CUDA card runs its stages as graph replays; off
# only to hold the graphs against the same stages run eagerly on the card.
_USE_GRAPHS = True


def reset_graph_stats() -> None:
    GRAPH_STATS.clear()


def _empty_like_tree(tree, dtype: Optional[torch.dtype] = None, rows: Optional[int] = None):
    """Uninitialized buffers shaped like the tensors of `tree`, floating
    ones in `dtype`, with `rows` instances when given."""
    def empty(a: Tensor) -> Tensor:
        shape = a.shape if rows is None else (rows,) + a.shape[1:]
        return torch.empty(shape, dtype=dtype if dtype is not None and a.is_floating_point() else a.dtype,
                           device=a.device)
    return tree_map(empty, tree)


def _copy_tree(dst, src) -> None:
    """dst.copy_(src) over the tensors of problem data (casting in the copy)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)


def _problem_buffers(bp: BatchedProblem, dtype: torch.dtype) -> BatchedProblem:
    return dataclasses.replace(bp, **{
        f: torch.empty_like(getattr(bp, f), dtype=dtype) for f in _POLY_FIELDS if getattr(bp, f) is not None})


def _copy_problem(dst: BatchedProblem, src: BatchedProblem) -> None:
    for f in _POLY_FIELDS:
        if getattr(dst, f) is not None:
            getattr(dst, f).copy_(getattr(src, f))


class _Stage:
    """One stage of the pipeline: `fn` reads and writes buffers only.  Run
    as a plain call, or captured once into a CUDA graph and replayed."""

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        # Per part of the graph — the top level, run once a replay, then
        # each captured loop or branch — the launches by name (and the
        # events noted), kernel nodes and copy nodes of one run or trip;
        # the kind of each loop or branch ("while", "if") and its counter of
        # trips or taken branches.
        self.parts: list = []
        self.kinds: list = []
        self.trips: Optional[Tensor] = None

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        self.replays += 1

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _loops.captured_counts()
        counters = torch.zeros(_MAX_LOOPS, dtype=torch.int64, device=stream.device)
        with _trace.setup_span("capture", stage=self.name) as sp:
            with _loops.log_loops(counters) as (loops, nested), _loops.loop_mode("capture"), \
                    torch.cuda.graph(graph, pool=pool, stream=stream):
                self.fn()
            t1 = time.perf_counter_ns()
            graph.instantiate()
            torch.cuda.synchronize()
        captured = _loops.captured_counts(since=before)
        self.parts = [(dict(captured - nested), *kern.graph_nodes(graph.raw_cuda_graph()))]
        self.parts += [(r.launches, *kern.graph_nodes(r.body)) for r in loops]
        self.kinds = [r.kind for r in loops]
        GRAPH_STATS.append({"stage": self.name, "capture_s": (t1 - sp.t0) / 1e9, "instantiate_s": (sp.t1 - t1) / 1e9,
                            "captured_launches": {k: v for k, v in captured.items() if k in kern.LAUNCHES},
                            "loops": self.kinds.count("while"), "branches": self.kinds.count("if"),
                            "kernel_nodes": sum(p[1] for p in self.parts)})
        self.graph, self.trips = graph, counters[:len(loops)]
        self.reset_counts()

    def reset_counts(self) -> None:
        self.replays = 0
        self.trips.zero_()

    def counts(self) -> Tuple[collections.Counter, int, int, dict]:
        """Kernel launches by name (and events noted), device kernels and
        device copies that the replays since the last `reset_counts()` ran,
        and the WHILE trips and taken IF branches by kind (one sync)."""
        runs = [self.replays] + self.trips.tolist()
        launches, kernels, copies = collections.Counter(), 0, 0
        for (per_run, k, c), n in zip(self.parts, runs):
            launches.update({name: v * n for name, v in per_run.items()})
            kernels, copies = kernels + k * n, copies + c * n
        by_kind = {kind: sum(n for kd, n in zip(self.kinds, runs[1:]) if kd == kind) for kind in ("while", "if")}
        return launches, kernels, copies, by_kind


class _ChunkBulk:
    """The f32 bulk of one chunk of `rows` instances (the JAX `bulk_one`
    under `vmap`): its data buffers, its result X, and its stage."""

    def __init__(self, pipe: "_Pipeline", rows: int):
        self.th = _empty_like_tree(pipe.th32, rows=rows)
        self.X0 = torch.empty((rows, pipe.n), dtype=torch.float32, device=pipe.device)
        self.X = torch.empty_like(self.X0)
        self.Y = None if pipe.Y32 is None else torch.empty((rows, pipe.Y32.shape[1]), dtype=torch.float32,
                                                           device=pipe.device)
        self.bp = map_poly_fields(pipe.bp32, lambda a: torch.empty((rows,) + a.shape[1:], dtype=a.dtype, device=a.device))
        opts = pipe.bulk_opts.resolve_tols(torch.float32)
        fns = self.bp.instance_fns(self.th)
        poly = self.bp.polyhedron(pipe.n, torch.float32, rows, pipe.device)

        def bulk() -> None:
            c = outer_init(fns, poly, self.X0, opts)
            c = outer_loop(fns, poly, opts, default_atol(torch.float32), c, ~outer_done(c, opts))
            self.X.copy_(c.x)
            if self.Y is not None:   # p > 0: the multipliers, and the AL outer iterations counted
                self.Y.copy_(final_multipliers(c))
                pipe.counts[0].add_((c.outer - 1).sum())

        self.stage = _Stage("bulk", bulk)

    def load(self, pipe: "_Pipeline", sl: slice) -> None:
        _copy_tree(self.th, tree_map(lambda a: a[sl], pipe.th32))
        self.X0.copy_(pipe.X0[sl])
        _copy_problem(self.bp, map_poly_fields(pipe.bp32, lambda a: a[sl]))


class _Pipeline:
    """Buffers and stages of one cache key (`_pipeline`)."""

    def __init__(self, bp: BatchedProblem, theta, X0: Tensor, bulk_opts: SolverOptions, chunk: int,
                 polish_kw: dict):
        self.device, (self.B, self.n) = X0.device, X0.shape
        self.bulk_opts, self.chunk = bulk_opts, chunk
        self.th32 = _empty_like_tree(theta, torch.float32)
        self.th64 = _empty_like_tree(theta, torch.float64)
        self.bp32 = _problem_buffers(bp, torch.float32)
        self.bp64 = _problem_buffers(bp, torch.float64)
        self.X0 = torch.empty((self.B, self.n), dtype=torch.float32, device=self.device)
        self.X32 = torch.empty_like(self.X0)
        p = 0 if bp.nlconstraints is None else bp.instance_fns(theta).nlconstraints(X0).shape[-1]
        self.Y32 = torch.empty((self.B, p), dtype=torch.float32, device=self.device) if p else None
        # With p > 0: the bulk's AL outer iterations and the lanes the first
        # polish round leaves uncertified, added up inside the stages
        # (`replay_counts()`).
        self.counts = torch.zeros(2, dtype=torch.int64, device=self.device) if p else None
        self.bulks: dict = {}
        polish = FusedPolish(self.bp32, self.th32, self.bp64, self.th64, **polish_kw)
        self.state: Optional[PolishState] = None

        def cert() -> None:
            s = polish.first_round(self.X32, self.Y32)
            if self.counts is not None:
                self.counts[1].add_((~s.ok).sum())
            s = polish.repolish(s)
            if self.state is None:   # the first, plain call allocates the results
                self.state = _loops.clone(s)
            _loops.copy_into(self.state, s)

        self.cert = _Stage("cert", cert)
        self.captured = False

    def load(self, bp: BatchedProblem, theta, X0: Tensor) -> None:
        _copy_tree(self.th32, theta)
        _copy_tree(self.th64, theta)
        _copy_problem(self.bp32, bp)
        _copy_problem(self.bp64, bp)
        self.X0.copy_(X0)

    def _bulk(self, rows: int) -> _ChunkBulk:
        if rows not in self.bulks:
            self.bulks[rows] = _ChunkBulk(self, rows)
        return self.bulks[rows]

    def run(self) -> PolishState:
        """The pipeline on the loaded data: the bulk chunk by chunk, then
        the certification of the whole batch."""
        for start in range(0, self.B, self.chunk):
            sl = slice(start, min(start + self.chunk, self.B))
            bulk = self._bulk(sl.stop - sl.start)
            with _trace.span("bulk", self.device, rows=sl.stop - sl.start):
                bulk.load(self, sl)
                bulk.stage()
                self.X32[sl].copy_(bulk.X)
                if bulk.Y is not None:
                    self.Y32[sl].copy_(bulk.Y)
        with _trace.span("cert", self.device):
            self.cert()
        return self.state

    def capture(self) -> None:
        """The first call with CUDA graphs: a plain run in eager mode on a
        side stream (lazy library state, the result buffers), then every
        stage captured into one memory pool.  No graph is replayed before
        all are captured, so the plain run's writes do no harm."""
        kern.load_library()
        stream = torch.cuda.Stream(device=self.device)
        with _trace.setup_span("warmup"):
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream), _loops.loop_mode("eager"):
                self.run()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
        pool = torch.cuda.graph_pool_handle()
        for stage in [b.stage for b in self.bulks.values()] + [self.cert]:
            stage.capture(pool, stream)
        self.captured = True


def _tree_spec(tree):
    if isinstance(tree, dict):
        return tuple((k, _tree_spec(v)) for k, v in sorted(tree.items()))
    return (tuple(tree.shape), tree.dtype)


# The pipelines (buffers and graphs) of the last few keys, least recent first.
_PIPELINES: collections.OrderedDict = collections.OrderedDict()
_MAX_PIPELINES = 8
# Trip counters of a stage's graph: at most this many loops captured.
_MAX_LOOPS = 256


def _captured_stages() -> list:
    return [st for p in _PIPELINES.values() for st in [b.stage for b in p.bulks.values()] + [p.cert]
            if st.graph is not None]


def reset_replay_counts() -> None:
    """Start the counts of `replay_counts()` again from 0."""
    for st in _captured_stages():
        st.reset_counts()
    for p in _PIPELINES.values():
        if p.counts is not None:
            p.counts.zero_()


def replay_counts() -> dict:
    """What the graph replays of the cached pipelines ran since the last
    `reset_replay_counts()` (exactly: a WHILE body's counts times the trips
    its loop ran, an IF body's times the replays that took it):
    {"launches": kernel launches of the port's wrappers by name,
    "device_kernels", "device_copies", "replays", "loop_trips": the trips
    of every WHILE node, "branches_taken": the taken IF nodes,
    "operator_builds": the materialized-operator builds by
    (factorization, dtype name), the replays' count of what
    `solver/subproblem.OPERATOR_BUILDS` counts in eager mode}; where a
    cached pipeline has nonlinear constraints (p > 0), also
    "al_outer_iters", the bulk's outer AL iterations summed over its
    lanes, and "polish_stragglers", the lanes the certification's first
    round left to its straggler passes, both counted on the device by the
    stages however they ran (replayed or as plain calls).  Syncs."""
    launches, kernels, copies, replays = collections.Counter(dict.fromkeys(kern.LAUNCHES, 0)), 0, 0, 0
    kinds = collections.Counter()
    for st in _captured_stages():
        l, k, c, by_kind = st.counts()
        launches.update(l)
        kinds.update(by_kind)
        kernels, copies, replays = kernels + k, copies + c, replays + st.replays
    builds = {key[1:]: v for key, v in launches.items() if isinstance(key, tuple) and key[0] == "operator_build" and v}
    out = {"launches": {k: launches[k] for k in kern.LAUNCHES}, "device_kernels": kernels, "device_copies": copies,
           "replays": replays, "loop_trips": kinds["while"], "branches_taken": kinds["if"],
           "operator_builds": builds}
    counts = [p.counts for p in _PIPELINES.values() if p.counts is not None]
    if counts:
        al_outer, stragglers = torch.stack([c.cpu() for c in counts]).sum(0).tolist()
        out.update(al_outer_iters=al_outer, polish_stragglers=stragglers)
    return out


def _pipeline(key, make) -> _Pipeline:
    """The pipeline of `key` — the problem functions, the shapes and dtypes
    of the data, the device, the options, the chunk, the polish settings
    and whether it runs as graphs (the JAX `_pipeline_runner`'s key) — made
    by `make()` when it is not cached."""
    pipe = _PIPELINES.pop(key, None) or make()
    _PIPELINES[key] = pipe
    while len(_PIPELINES) > _MAX_PIPELINES:
        _PIPELINES.popitem(last=False)
    return pipe


def solve_small_fused(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    polish_steps: int = 5,
    bulk_crit_tol: Optional[float] = 1e-2,
    bulk_max_inner: Optional[int] = 8,
    active_tol: float = 1e-4,
    refactor_steps: int = 2,
    rounds: int = 2,
    straggler_bucket: int = 64,
    fallback_pad: int = 64,
    fallback_device=None,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Mixed-precision solve of a small-n family on X0's device as graph
    replays; returns f64 (X, Y, SolveInfo) certified at f64 KKT grade.

    Semantics of `solve_mixed_precision(..., certify="device")` with the
    bulk's loosened crit_tol and inner cap; only the scheduling differs.
    `fallback_device=None` runs the fallback refine of uncertified lanes on
    X0's device ("cpu": on the host, and the results come back there).
    `fallback_pad` keeps the JAX signature and is refused at any value but
    64 (`batch/polish._check_fallback_pad`: the port pads no bucket).  On
    a CUDA card the stages run as graph replays, on the CPU as plain calls
    in the current loop mode.  A bulk that materializes an (n, n) operator
    (n ≥ 64 with a tall Jacobian, `solver/subproblem.resolve_operator_route`)
    builds it inside the bulk's graph, its rebuilds and rescues behind IF
    nodes.
    `options.verbose` raises (`ValueError`, on either device): a WHILE
    node's body cannot write the log's rows on the host.
    """
    from .refine import _cast_problem, _cast_tree, nlcons_bulk_options, true_f32_matmuls

    if options.verbose:
        raise ValueError("solve_small_fused: verbose=True writes its rows on the host from eager loops, and this "
                         "route runs its loops as CUDA-graph WHILE nodes; use fuse=False")
    _check_fallback_pad("solve_small_fused", fallback_pad)
    B, n = X0.shape
    dev = X0.device
    graphs = dev.type == "cuda" and _USE_GRAPHS
    bulk_opts = nlcons_bulk_options(dataclasses.replace(
        options,
        crit_tol=bulk_crit_tol,
        max_inner_iter=options.max_inner_iter if bulk_max_inner is None else min(bulk_max_inner, options.max_inner_iter),
    ), bp, bulk_crit_tol)
    true_f32_matmuls()
    chunk = max(min(chunk, B), 1)
    polish_kw = (("options", options), ("num_steps", polish_steps), ("active_tol", active_tol), ("reg", 0.0),
                 ("refactor_steps", refactor_steps), ("rounds", rounds), ("straggler_bucket", straggler_bucket))
    poly_spec = tuple((f, _tree_spec(getattr(bp, f))) for f in _POLY_FIELDS if getattr(bp, f) is not None)
    key = ((bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons, bp.poly_batched, bp.lagrangian_curvature),
           _tree_spec(theta),
           poly_spec, _tree_spec(X0), str(dev), bulk_opts, chunk, polish_kw, graphs)
    pipe = _pipeline(key, lambda: _Pipeline(bp, theta, X0, bulk_opts, chunk, dict(polish_kw)))

    with _trace.span("load", dev):
        bp64, theta64 = _cast_problem(bp, torch.float64, dev), _cast_tree(theta, torch.float64)
        pipe.load(bp, theta, X0)
    if graphs and not pipe.captured:
        pipe.capture()
    s = pipe.run()
    return finish_polish(bp64, theta64, [t.clone() for t in s[:6]], options, polish_steps, chunk, fallback_device)
