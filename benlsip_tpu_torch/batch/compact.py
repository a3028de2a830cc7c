"""Converged-instance compaction for the bulk lockstep loop (PyTorch port
of `benlsip_tpu/batch/compact.py`).

The chunked bulk solve (`batch/vmap_solve.solve_batched_chunked`) runs
each chunk's masked loops to its SLOWEST lane: on the exp-fit families
most lanes need 2-3 outer iterations, while every chunk pays its tail
lane's whole schedule.  This module splits the solve at a fixed
outer-iteration horizon:

  stage A  — every chunk runs AT MOST `stage_outer` outer iterations
             (the carry's per-lane `outer` counter makes the cap one more
             term of the loop predicate) and finalizes (X, Y, info), valid
             for the lanes that finished;
  compact  — one host read of the chunks' done mask gives the survivor
             lanes;
  stage B  — the survivors, gathered with their carry, data and
             per-instance constraint fields into buckets of at most
             `survivor_chunk` lanes, run the rest of the schedule to
             their own convergence, and their results are scattered back.

A masked loop freezes a finished lane, and every lane computes only from
its own state, so cutting the loop at any horizon leaves each lane's
trajectory as it was: the compacted solve returns the chunked solve's
results (held bit for bit on the CPU by `tests/test_torch_compact.py`).
The gain is wall-clock only: a wide chunk stops at the horizon, and the
tail is paid once in a narrow bucket instead of once per chunk.

Eager PyTorch compiles nothing, so a ragged chunk or bucket runs at its
own size (the JAX module pads them to powers of two, and gathers and
scatters in one jitted call each to save relay dispatches; here they are
plain indexing).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._batched import cat_batches, tree_map
from .._loops import host_nonzero, masked_while
from ..solver.options import SolverOptions, matmul_precision
from ..solver.outer import (
    OuterCarry,
    SolveInfo,
    default_atol,
    finalize,
    outer_body,
    outer_done,
    outer_init,
    outer_loop,
)
from ..solver.subproblem import linear_gram_cache
from .vmap_solve import BatchedProblem, map_poly_fields

Tensor = torch.Tensor
# Per compacted solve since the last `reset_stats()`: its lanes, the
# survivors of stage A and their buckets.
STATS: list = []


def reset_stats() -> None:
    STATS.clear()


def _stage(bp: BatchedProblem, theta, X0: Tensor, opts: SolverOptions, atol: float, stage_outer: int):
    """A chunk: at most `stage_outer` outer iterations from X0, finalized.
    Returns (carry, X, Y, info, done); X, Y, info hold for the done lanes."""
    B, n = X0.shape
    fns = bp.instance_fns(theta)
    poly = bp.polyhedron(n, X0.dtype, B, X0.device)
    with matmul_precision(opts.matmul_precision):
        c = outer_init(fns, poly, X0, opts)
        gram_cache = linear_gram_cache(fns, c.x, opts)
        cond = lambda c: ~(outer_done(c, opts) | (c.outer > stage_outer))
        c = masked_while(
            cond, lambda c, act: outer_body(fns, poly, opts, atol, c, active=act, gram_cache=gram_cache),
            c, cond(c), stage_outer + 1,
        )
        return (c,) + finalize(fns, c, opts) + (outer_done(c, opts),)


def _resume(bp: BatchedProblem, theta, c: OuterCarry, opts: SolverOptions, atol: float):
    """Lanes resumed from their carry to convergence, finalized; the
    constant-J cache is recomputed from the carry's x."""
    B, n = c.x.shape
    fns = bp.instance_fns(theta)
    poly = bp.polyhedron(n, c.x.dtype, B, c.x.device)
    with matmul_precision(opts.matmul_precision):
        gram_cache = linear_gram_cache(fns, c.x, opts)
        c = outer_loop(fns, poly, opts, atol, c, ~outer_done(c, opts), gram_cache)
        return finalize(fns, c, opts)


def solve_batched_compact(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    stage_outer: int = 2,
    survivor_chunk: Optional[int] = None,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Batched solve with converged-instance compaction at a fixed outer
    horizon: a drop-in for `solve_batched_chunked` with the same results.

    stage_outer: the wide stage's outer-iteration horizon.
    survivor_chunk: the largest survivor bucket (default and cap: chunk).
    """
    B = X0.shape[0]
    chunk = max(min(chunk, B), 1)
    cap = max(min(survivor_chunk or chunk, chunk), 1)
    opts = options.resolve_tols(X0.dtype)
    atol = default_atol(X0.dtype)

    parts = []
    for start in range(0, B, chunk):
        sl = slice(start, min(start + chunk, B))
        parts.append(_stage(map_poly_fields(bp, lambda a: a[sl]), tree_map(lambda a: a[sl], theta), X0[sl],
                            opts, atol, int(stage_outer)))
    carry, X, Y, info, done = cat_batches(parts)
    survivors = host_nonzero(~done)
    STATS.append({"lanes": B, "survivors": len(survivors), "buckets": -(-len(survivors) // cap)})
    if not len(survivors):
        return X, Y, info

    X, Y = X.clone(), Y.clone()
    info = SolveInfo(*[t.clone() for t in info])
    for start in range(0, len(survivors), cap):
        idx = survivors[start:start + cap].to(X0.device)
        take = lambda a: a[idx]
        Xb, Yb, ib = _resume(map_poly_fields(bp, take), tree_map(take, theta),
                             OuterCarry(*[take(t) for t in carry]), opts, atol)
        X[idx], Y[idx] = Xb, Yb
        for t, t_b in zip(info, ib):
            t[idx] = t_b
    return X, Y, info
