"""Polyhedral constraint set and masked active-set machinery (PyTorch port
of `benlsip_tpu/ops/constraints.py`).

Batch-first: every field carries a leading instance axis B.  The active
set is a boolean mask `fixed` (B, n) and every projection factorization
works on the fixed-size m×m matrix A Z Aᵀ, Z = diag(¬fixed) — one small
batched Cholesky per mask update (see `ops/cholesky.py`).  Empty
constraint blocks (m == 0, infinite bounds) are supported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._batched import mv, norm
from .cholesky import factor_unfixed_aat, masked_projection

Tensor = torch.Tensor


def sqrt_eps(dtype: torch.dtype) -> float:
    """The reference's default tolerance sqrt(eps(T)), the square root
    taken in T as the JAX package takes it."""
    return float(torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype)))


class Polyhedron(NamedTuple):
    """The feasible polyhedra {x : Ax = b, xl ≤ x ≤ xu} of a batch."""

    A: Tensor   # (B, m, n)
    b: Tensor   # (B, m)
    xl: Tensor  # (B, n), may be -inf
    xu: Tensor  # (B, n), may be +inf


class ActiveSet(NamedTuple):
    """Masked active-bound state + its projection factorization."""

    fixed: Tensor  # bool (B, n)
    chol: Tensor   # (B, m, m) lower factor of A Z Aᵀ


def nb_fix(aset: ActiveSet) -> Tensor:
    """Number of fixed variables per lane (int32)."""
    return aset.fixed.sum(-1, dtype=torch.int32)


def make_active_set(poly: Polyhedron, fixed: Tensor, reg: float = 0.0) -> ActiveSet:
    """ActiveSet for mask `fixed`, refreshing the factorization."""
    return ActiveSet(fixed=fixed, chol=factor_unfixed_aat(poly.A, fixed, reg=reg))


def no_active_set(poly: Polyhedron, reg: float = 0.0) -> ActiveSet:
    """ActiveSet with no fixed variables."""
    B, _, n = poly.A.shape
    return make_active_set(poly, torch.zeros((B, n), dtype=torch.bool, device=poly.A.device), reg=reg)


def active_bounds_at(poly: Polyhedron, x: Tensor, atol) -> Tensor:
    """Mask of bounds active at x up to atol (infinite bounds never activate)."""
    return ((x - poly.xl) <= atol) | ((poly.xu - x) <= atol)


def step_active_bounds(poly: Polyhedron, x: Tensor, s: Tensor, delta: Tensor, atol) -> Tensor:
    """Mask of bounds hit by step s from x inside the ∞-norm trust region
    of per-lane radius delta (B,)."""
    d = delta.unsqueeze(-1)
    s_l = torch.maximum(poly.xl - x, -d)
    s_u = torch.minimum(poly.xu - x, d)
    return ((s - s_l) <= atol) | ((s_u - s) <= atol)


def binding_bounds_at(poly: Polyhedron, x: Tensor, g: Tensor, atol) -> Tensor:
    """Mask of bounds active at x AND binding for descent direction -g."""
    d = -g
    at_lo = (x - poly.xl) <= atol
    at_hi = (poly.xu - x) <= atol
    return (at_lo & (d <= 0)) | (at_hi & (d >= 0))


def binding_bounds_coupled(
    poly: Polyhedron, x: Tensor, g: Tensor, atol, reg: float = 0.0, passes: int = 2
) -> Tensor:
    """Binding active bounds under Ax = b coupling, via projection
    multipliers (see the JAX twin for the derivation): start with every
    active bound fixed, project -g, release the bounds whose candidate
    freed component points back into the box; `passes` rounds."""
    r = -g
    at_lo = torch.isfinite(poly.xl) & ((x - poly.xl) <= atol)
    at_hi = torch.isfinite(poly.xu) & ((poly.xu - x) <= atol)
    active = at_lo | at_hi
    pinned = at_lo & at_hi
    if poly.A.shape[-2] == 0:
        release = ((at_lo & (r > 0)) | (at_hi & (r < 0))) & ~pinned
        return active & ~release

    fixed = active
    for _ in range(passes):
        L = factor_unfixed_aat(poly.A, fixed, reg=reg)
        sigma = masked_projection(poly.A, L, fixed, r, unmasked_output=True)
        # NaN guard: a rank-deficient A Z Aᵀ makes sigma NaN; release nothing then.
        release = ((at_lo & (sigma > 0)) | (at_hi & (sigma < 0))) & torch.isfinite(sigma)
        fixed = active & ~(release & ~pinned)
    return fixed


def add_active(poly: Polyhedron, aset: ActiveSet, mask_or_index, reg: float = 0.0) -> ActiveSet:
    """Union new active variables into the set and refresh the factorization.

    Accepts a boolean mask (B, n) (unioned) or per-lane indices (B,)."""
    if mask_or_index.dtype == torch.bool:
        fixed = aset.fixed | mask_or_index
    else:
        fixed = aset.fixed.scatter(-1, mask_or_index.long().unsqueeze(-1), True)
    return make_active_set(poly, fixed, reg=reg)


def is_feasible(poly: Polyhedron, x: Tensor, rtol: float = 1e-8) -> Tensor:
    """Per-lane feasibility: Ax ≈ b (backward-error scaled) and xl ≤ x ≤ xu."""
    bounds_ok = (poly.xl <= x).all(-1) & (x <= poly.xu).all(-1)
    if poly.A.shape[-2] == 0:
        return bounds_ok
    ax = mv(poly.A, x)
    scale = torch.maximum(
        torch.maximum(norm(ax), norm(poly.b)),
        torch.linalg.matrix_norm(poly.A) * norm(x),
    )
    lin_ok = norm(ax - poly.b) <= rtol * scale + torch.finfo(x.dtype).tiny
    return lin_ok & bounds_ok
