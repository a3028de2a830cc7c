"""Distributed solves on torch.distributed (PyTorch port of
`benlsip_tpu/dist/sharded.py`): data-parallel batched solves, and the
blocked-Jacobian mode for one large instance (BASELINE config 4).

Data parallel (`solve_batched_shardmap`): each rank solves its slice of the
batch over the mesh dim "batch" with its own loop exit; no collective runs
in the loop, and one all_gather per output assembles the batch on every
rank.

Blocked (`solve_large_blocked_shardmap`): each rank holds a block of the
residual rows over the mesh dim "block" and runs the whole solver on them
with `SolverOptions.spmd_axis="block"`: every contraction over the residual
dimension (rᵀr, Jᵀr, JᵀJ, ‖Jv‖²) carries one explicit all-reduce
(`dist/collectives.py`), and everything else — constraint algebra,
projections, active sets, the trust-region state machine — is replicated
arithmetic on n-vectors, so every rank takes the same branches.  torch has
no SPMD partitioner, so the JAX package's declarative (pjit) paths
(`solve_large_blocked`, `solve_large_blocked_family`) are the plain
replicated solve on a mesh whose "block" dim is 1, and the explicit
path above on a larger one — the same algorithm, which the JAX package's
own tests pin to its pjit twin.

Instances of one rank's solve are batch-first like the rest of the port;
the single-instance entries take x0 (n,) and return x (n,), y (p,) and a
`SolveInfo` of 0-dim tensors, as `solver/api.solve` does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._batched import tree_map
from ..batch.vmap_solve import BatchedProblem, map_poly_fields, solve_batched
from ..solver.api import NLSFunctions, Problem
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, solve_fixed_point
from .collectives import all_gather, bind_mesh
from .mesh import batch_sharding, block_rows_sharding, dim_size, shard_batch

Tensor = torch.Tensor


def solve_batched_shardmap(
    bp: BatchedProblem, theta, X0: Tensor, options: SolverOptions, mesh,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Data-parallel batched solve with a per-rank loop exit.

    The batch (B divisible by the mesh's "batch" size) is split over
    "batch": theta, X0 and the per-instance constraint fields are sliced to
    this rank's lanes, which it solves alone — its loops end when its own
    lanes are done, and nothing crosses ranks until the end.  The results
    are all-gathered, so every rank returns the whole batch's (X, Y,
    SolveInfo), identical per lane to `solve_batched` on one process."""
    B = X0.shape[0]
    nshards = dim_size(mesh, "batch")
    if B % nshards:
        raise ValueError(f"batch {B} not divisible by mesh batch axis {nshards}")
    local = map_poly_fields(bp, lambda a: batch_sharding(mesh, a))
    X, Y, info = solve_batched(local, shard_batch(theta, mesh), batch_sharding(mesh, X0), options)
    with bind_mesh(mesh):
        gather = lambda t: all_gather(t, "batch")
        return gather(X), gather(Y), SolveInfo(*[gather(f) for f in info])


def solve_batched_sharded(
    bp: BatchedProblem, theta, X0: Tensor, options: SolverOptions, mesh,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Data-parallel batched solve over the mesh's "batch" dim.  The JAX
    version is one SPMD program whose loop predicate is reduced over the
    whole mesh every iteration; with no partitioner here every rank runs
    its own program, so this is `solve_batched_shardmap`."""
    return solve_batched_shardmap(bp, theta, X0, options, mesh)


def blocked_jacobian_fns(fns: NLSFunctions, mesh) -> NLSFunctions:
    """This rank's row block, over the mesh dim "block", of every residual
    and Jacobian evaluation (B, d) / (B, d, n); the nonlinear constraints
    stay whole on every rank.  The identity on a mesh whose "block" is 1.
    The JAX version constrains the layout for XLA's partitioner; here the
    solver sums over the blocks itself (`SolverOptions.spmd_axis`)."""
    if dim_size(mesh, "block") == 1:
        return fns
    return NLSFunctions(
        residuals=lambda X: block_rows_sharding(mesh, fns.residuals(X), -1),
        nlconstraints=fns.nlconstraints,
        jac_res=lambda X: block_rows_sharding(mesh, fns.jac_res(X), -2),
        jac_nlcons=fns.jac_nlcons,
    )


def _resolve_blocked_options(options: SolverOptions) -> SolverOptions:
    """Blocked mode resolves gn_factorization="auto" to "normal": the Gram
    refresh is one GEMM and one (n, n) reduce, the cheapest refresh at
    config-4 scale; "cholqr2" distributes too and is the route to force
    when κ-grade accuracy matters ("qr" does not distribute)."""
    if options.gn_factorization == "auto":
        return dataclasses.replace(options, gn_factorization="normal")
    return options


def _blocked_axis(options: SolverOptions, mesh) -> SolverOptions:
    """The plain solve on a one-block mesh; the explicit path on more."""
    if dim_size(mesh, "block") > 1:
        return dataclasses.replace(options, spmd_axis="block")
    return options


def _one(X: Tensor, Y: Tensor, info: SolveInfo):
    return X[0], Y[0], SolveInfo(*[f[0] for f in info])


def solve_large_blocked(
    problem: Problem, x0: Tensor, options: SolverOptions, mesh,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Solve one large instance with the residual rows blocked over the
    mesh dim "block" (d divisible by its size).  Every rank evaluates the
    problem's callables whole and keeps its rows; for data at device-memory
    scale use `solve_large_blocked_family`, which hands each rank its rows
    of the data."""
    options = _blocked_axis(_resolve_blocked_options(options), mesh)
    fns, poly = problem.build(x0.shape[0], x0.dtype, x0.device)
    with bind_mesh(mesh):
        return _one(*solve_fixed_point(blocked_jacobian_fns(fns, mesh), poly, x0[None], options))


def _solve_blocked(bp: BatchedProblem, theta, x0: Tensor, options: SolverOptions, mesh):
    """One instance with its data theta: every leaf whose leading axis
    divides over "block" is row-blocked to this rank's rows, the others
    are whole; the batch axis of one is a view (`unsqueeze`), never a copy."""
    block = dim_size(mesh, "block")

    def place(a):
        if a.ndim >= 1 and a.shape[0] % block == 0:
            a = block_rows_sharding(mesh, a)
        return a.unsqueeze(0)

    n = x0.shape[0]
    poly = bp.polyhedron(n, x0.dtype, 1, x0.device)
    with bind_mesh(mesh):
        return _one(*solve_fixed_point(bp.instance_fns(tree_map(place, theta)), poly, x0[None], options))


def solve_large_blocked_family(
    bp: BatchedProblem, theta, x0: Tensor, options: SolverOptions, mesh,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """The config-4 path: one instance of a family (callables of (x, theta))
    with its large data in theta, e.g. {"J": (d, n), "y": (d,)} from
    `problems/generators.blocked_hard_family`.  On a one-block mesh the
    plain solve with the blocked options; on more, each rank holds its
    rows of theta and the solver sums over them (`spmd_axis="block"`)."""
    options = _blocked_axis(_resolve_blocked_options(options), mesh)
    return _solve_blocked(bp, theta, x0, options, mesh)


def solve_large_blocked_shardmap(
    bp: BatchedProblem, theta, x0: Tensor, options: SolverOptions, mesh,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Config-4 blocked solve with explicit collectives on any mesh: each
    rank holds its rows of theta (the leaves whose leading axis divides
    over "block") and every contraction over them carries one psum over
    "block" (`spmd_axis="block"`, also on a one-block mesh, where each
    collective is the identity).  `gram_hessian="auto"` becomes "on": one
    n² reduce per refresh instead of a psum per CG iteration; an explicit
    "off" stays matrix-free.

    Layout knobs (SolverOptions): `gram_layout="sharded"` keeps each
    rank's n/D rows of the operator (a reduce-scatter refresh, n²/D memory,
    an n-vector all_gather per H·v; n divisible by D);
    `reduce_schedule="ring"` builds that reduce-scatter from D−1
    point-to-point hops, one (n/D, n) chunk at a time."""
    options = dataclasses.replace(
        _resolve_blocked_options(options),
        spmd_axis="block",
        gram_hessian="on" if options.gram_hessian == "auto" else options.gram_hessian,
    )
    return _solve_blocked(bp, theta, x0, options, mesh)
