"""Padding and bucketing for heterogeneous instance families (PyTorch
port of `benlsip_tpu/batch/buckets.py`).

A batch shares its shapes; real sweeps (BASELINE config 5: 100k
parameter-estimation instances) have ragged residual counts and
divergent difficulty.  Two tools:

* shape padding — pad the residual vector with zeros (zero residuals
  contribute nothing to r, J, g or the Gauss-Newton Hessian, so padded
  instances solve identically) and bucket instances into a few padded
  shapes to bound the waste;
* difficulty ordering — a chunk's masked loops run at the speed of its
  slowest lane, so ranking instances by a cheap pilot run with small caps
  and chunking them in that order puts the tail into its own chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from .._batched import tree_map
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from .vmap_solve import BatchedProblem, map_poly_fields, solve_batched_chunked

Tensor = torch.Tensor


def pad_residuals(residuals: Callable, d_target: int) -> Callable:
    """Wrap a per-instance residuals(x, theta_i) -> (d,) into a (d_target,)
    version padded with zeros.  Exact: zero rows of r and J drop out of
    every contraction."""

    def padded(x, theta):
        r = residuals(x, theta)
        return torch.cat([r, r.new_zeros((d_target - r.shape[0],))])

    return padded


def bucket_edges(sizes: Sequence[int], max_buckets: int = 4) -> List[int]:
    """At most max_buckets padded sizes covering `sizes`, at quantiles of
    the distinct sizes (the largest always among them)."""
    uniq = sorted(set(int(s) for s in sizes))
    if len(uniq) <= max_buckets:
        return uniq
    qs = np.linspace(0, 1, max_buckets + 1)[1:]
    edges = sorted(set(int(np.quantile(uniq, q, method="higher")) for q in qs))
    if edges[-1] < uniq[-1]:
        edges[-1] = uniq[-1]
    return edges


def assign_buckets(sizes: Sequence[int], edges: Sequence[int]) -> List[np.ndarray]:
    """Instance indices per bucket (the first edge ≥ size)."""
    sizes = np.asarray(sizes)
    out = []
    prev = -1
    for e in edges:
        out.append(np.flatnonzero((sizes > prev) & (sizes <= e)))
        prev = e
    return out


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)


def difficulty_order(inner_iters) -> np.ndarray:
    """Sort order grouping similar-cost instances, cheap first (stable):
    feed pilot-run iteration counts and chunk the reordered batch."""
    return np.argsort(_numpy(inner_iters), kind="stable")


def reorder(tree, order: np.ndarray):
    """Apply an instance permutation to batched data (a tensor or a dict
    of them); the index goes to each tensor's device."""
    return tree_map(lambda a: a[torch.as_tensor(order, device=a.device)], tree)


def inverse_order(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return inv


def solve_batched_sorted(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions,
    chunk: int = 128,
    pilot_outer: int = 2,
    pilot_inner: int = 8,
):
    """Chunked batched solve in difficulty order.

    A capped pilot run (chunks of max(chunk, 512)) ranks instances by the
    TR iterations they used, those it left unconverged last; the real
    solve then runs chunks of `chunk` in that order, so each chunk waits
    only for peers of similar cost.  Results come back in the original
    instance order.
    """
    pilot_opts = dataclasses.replace(options, max_outer_iter=pilot_outer, max_inner_iter=pilot_inner)
    _, _, pilot = solve_batched_chunked(bp, theta, X0, pilot_opts, chunk=max(chunk, 512))
    cost = _numpy(pilot.inner_iters) + 1000 * (~_numpy(pilot.converged))
    order = np.argsort(cost, kind="stable")
    idx = torch.as_tensor(order, device=X0.device)
    take = lambda a: a[idx]
    X, Y, info = solve_batched_chunked(map_poly_fields(bp, take), tree_map(take, theta), X0[idx], options, chunk=chunk)
    inv = torch.as_tensor(inverse_order(order), device=X.device)
    return X[inv], Y[inv], SolveInfo(*[t[inv] for t in info])
