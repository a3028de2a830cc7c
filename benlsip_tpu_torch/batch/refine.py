"""Mixed-precision pipeline: f32 bulk solve + f64 certification (PyTorch
port of `solve_mixed_precision` and `refine_f64` in
`benlsip_tpu/batch/refine.py`).

1. bulk phase — the full TRALCNLLS iteration in float32, to a loose
   criticality tolerance (it only has to identify the active set and land
   in the polish's Newton basin);
2. certification — the fused SQP polish (float32 QR factors, float64
   chord steps, exact-projection certificate) with the full f64 refine as
   the fallback for the lanes it cannot certify.

Everything runs on the device the data are on, the f64 fallback included:
the H100 has native float64, so the JAX package's `refine_device="cpu"`
(chosen for a TPU that emulates f64) has no counterpart here.  The
scheduling knobs of the JAX pipeline keep their parameters; "auto"
resolves to the plain path and an explicit non-default value raises
`NotImplementedError` until its route is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._batched import tree_map
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from .vmap_solve import BatchedProblem, solve_batched_chunked

Tensor = torch.Tensor


def _cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def _cast_problem(bp: BatchedProblem, dtype: torch.dtype, device) -> BatchedProblem:
    """bp with its constraint data cast to dtype on device."""
    cast = lambda a: None if a is None else a.to(device=device, dtype=dtype)
    return dataclasses.replace(bp, A=cast(bp.A), b=cast(bp.b), xl=cast(bp.xl), xu=cast(bp.xu))


def refine_f64(
    bp: BatchedProblem, theta, X: Tensor, options: SolverOptions = SolverOptions(),
    max_outer: int = 10, chunk: int = 512,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Refine batched solutions X to f64 KKT grade with the full solver
    (warm start, at most `max_outer` outer iterations) on X's device."""
    opts = dataclasses.replace(options, max_outer_iter=max_outer)
    dev = X.device
    bp64 = _cast_problem(bp, torch.float64, dev)
    theta64 = _cast_tree(tree_map(lambda a: a.to(dev), theta), torch.float64)
    return solve_batched_chunked(bp64, theta64, X.to(torch.float64), opts, chunk=chunk)


def _resolve_bulk_max_inner(bulk_max_inner, n: int, polish: bool):
    """"auto": cap the bulk phase's per-subproblem TR iterations at 8 for
    small instances (n ≤ 8) when the polish absorbs the slack; it changes
    the bulk iterates, so it is kept for parity with the JAX pipeline."""
    if bulk_max_inner != "auto":
        return bulk_max_inner
    return 8 if (polish and n <= 8) else None


def _require_plain(name: str, value, plain) -> None:
    if value != plain and value != "auto":
        raise NotImplementedError(f"solve_mixed_precision({name}={value!r}): not ported yet")


def solve_mixed_precision(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    sort_by_difficulty: bool = False,
    polish: bool = True,
    polish_steps: int = 5,
    bulk_crit_tol=1e-2,
    certify: str = "auto",
    pipeline_overlap: bool = False,
    bulk_dtype: torch.dtype = torch.float32,
    bulk_max_inner="auto",
    bulk_compact="auto",
    fuse="auto",
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """f32 bulk solve + f64 certification on X0's device; returns f64
    (X, Y, SolveInfo).

    certify: "auto" or "device" (the fused device certification); "host"
    is not ported.  polish=False refines every instance with the full f64
    solver instead.  bulk_crit_tol relaxes the bulk phase's criticality
    tolerance (None: the f32 floor); bulk_max_inner caps its inner
    iterations ("auto": 8 for n ≤ 8).  fuse, bulk_compact,
    sort_by_difficulty and pipeline_overlap keep the JAX signature; only
    their plain settings are ported, as is only a float32 bulk_dtype.
    """
    _require_plain("fuse", fuse, False)
    _require_plain("bulk_compact", bulk_compact, None)
    _require_plain("sort_by_difficulty", sort_by_difficulty, False)
    _require_plain("pipeline_overlap", pipeline_overlap, False)
    if certify not in ("auto", "device"):
        raise NotImplementedError(f"solve_mixed_precision(certify={certify!r}): not ported yet")
    if bulk_dtype != torch.float32:
        raise NotImplementedError(f"solve_mixed_precision(bulk_dtype={bulk_dtype}): not ported yet")

    # Bulk matmuls stay true f32 (the JAX package's matmul_precision="highest").
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = X0.device
    bulk_max_inner = _resolve_bulk_max_inner(bulk_max_inner, X0.shape[-1], polish)
    theta32 = _cast_tree(theta, torch.float32)
    bp32 = _cast_problem(bp, torch.float32, dev)
    X0_32 = X0.to(torch.float32)

    bulk_opts = options
    if polish and bulk_crit_tol is not None:
        bulk_opts = dataclasses.replace(bulk_opts, crit_tol=bulk_crit_tol)
    if polish and bulk_max_inner is not None:
        bulk_opts = dataclasses.replace(
            bulk_opts, max_inner_iter=min(bulk_max_inner, options.max_inner_iter)
        )
    X32, _, _ = solve_batched_chunked(bp32, theta32, X0_32, bulk_opts, chunk=chunk)
    if polish:
        from .polish import polish_then_refine

        return polish_then_refine(
            bp, theta, X32, options, num_steps=polish_steps, chunk=chunk,
            bp32=bp32, theta32=theta32,
        )
    return refine_f64(bp, theta, X32, options, chunk=chunk)
