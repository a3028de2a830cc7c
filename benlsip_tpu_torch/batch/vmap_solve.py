"""Batched solving of independent NLS instances (PyTorch port of
`benlsip_tpu/batch/vmap_solve.py`).

A family of instances shares shapes (n, d, p, m) and differs in its data
theta (and optionally in per-instance constraint data).  The JAX package
writes one instance and lifts it with `vmap`; the port's solver is
batch-first throughout, so a family is solved by handing the batched
callables and the batched polyhedron to `solve_fixed_point` directly.
Lanes whose loops finish early stop updating (per-lane masks) while the
slowest lane of the chunk runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from .._batched import cat_batches, tree_map
from ..ops.constraints import Polyhedron
from ..solver.api import NLSFunctions, autodiff_jacobian, empty_jac_nlcons, empty_nlconstraints
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, solve_fixed_point

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchedProblem:
    """A family of NLS instances parameterized by per-instance data theta.

    residuals / nlconstraints / jacobians are PER-INSTANCE functions of
    (x (n,), theta_i), written with torch ops; theta is a dict (or other
    tuple/list tree) of tensors with a leading batch axis.  Constraint
    data may be shared (no batch axis) or per-instance (leading batch
    axis), declared by `poly_batched`.  `lagrangian_curvature(x, y,
    theta_i)` (n, n) is the second-order part of the Lagrangian's Hessian
    that Gauss-Newton leaves out, Σⱼ rⱼ∇²rⱼ(x) + Σᵢ yᵢ∇²cᵢ(x) at the
    multipliers y (p,); the certification's polish adds it to its KKT
    matrix when p > 0.  Left None it comes from autodiff (the forward-mode
    Jacobian of Jᵀr + Cᵀy less JᵀJ).  (The JAX package has no such hook:
    its polish is Gauss-Newton throughout.)
    """

    residuals: Callable[[Tensor, Any], Tensor]
    nlconstraints: Optional[Callable[[Tensor, Any], Tensor]] = None
    jac_res: Optional[Callable[[Tensor, Any], Tensor]] = None
    jac_nlcons: Optional[Callable[[Tensor, Any], Tensor]] = None
    A: Optional[Tensor] = None
    b: Optional[Tensor] = None
    xl: Optional[Tensor] = None
    xu: Optional[Tensor] = None
    poly_batched: bool = False
    lagrangian_curvature: Optional[Callable[[Tensor, Tensor, Any], Tensor]] = None

    def instance_fns(self, theta) -> NLSFunctions:
        """Bind the batch's theta into batched callables of X (B, n)."""
        vmap = torch.func.vmap
        res = vmap(self.residuals)
        # A hand-written Jacobian is passed through as given; an autodiff
        # one is cast to x's dtype (`autodiff_jacobian`).
        jr_one = self.jac_res if self.jac_res is not None else autodiff_jacobian(self.residuals)
        jr = vmap(jr_one)
        curv = None
        if self.nlconstraints is None:
            nlc, jc = empty_nlconstraints, empty_jac_nlcons   # p == 0
        else:
            jac_one = self.jac_nlcons if self.jac_nlcons is not None else autodiff_jacobian(self.nlconstraints)
            nlc_v = vmap(self.nlconstraints)
            jc_v = vmap(jac_one)
            curv_v = vmap(self.lagrangian_curvature if self.lagrangian_curvature is not None
                          else autodiff_curvature(self.residuals, self.nlconstraints, jr_one))

            def nlc(X):
                return nlc_v(X, theta)

            def jc(X):
                return jc_v(X, theta)

            def curv(X, Y):
                return curv_v(X, Y, theta)

        return NLSFunctions(
            residuals=lambda X: res(X, theta),
            nlconstraints=nlc,
            jac_res=lambda X: jr(X, theta),
            jac_nlcons=jc,
            lagrangian_curvature=curv,
        )

    def polyhedron(self, n: int, dtype: torch.dtype, B: int, device) -> Polyhedron:
        """The batch's polyhedron with every field expanded to a leading B axis."""
        kw = {"dtype": dtype, "device": device}
        A = self.A.to(**kw) if self.A is not None else torch.zeros((0, n), **kw)
        m = A.shape[-2]
        b = self.b.to(**kw) if self.b is not None else torch.zeros(A.shape[:-2] + (m,), **kw)
        xl = self.xl.to(**kw) if self.xl is not None else torch.full((n,), -float("inf"), **kw)
        xu = self.xu.to(**kw) if self.xu is not None else torch.full((n,), float("inf"), **kw)
        fields = Polyhedron(A=A, b=b, xl=xl, xu=xu)
        return Polyhedron(*[
            f if f.ndim > base else f.expand((B,) + f.shape)
            for f, base in zip(fields, _POLY_BASE_RANK)
        ])


def autodiff_curvature(residuals: Callable, nlconstraints: Callable, jac_res: Callable) -> Callable:
    """x, y, theta_i ↦ Σⱼ rⱼ∇²rⱼ(x) + Σᵢ yᵢ∇²cᵢ(x) of one instance: the
    Hessian of the Lagrangian ½‖r‖² + yᵀc (forward over reverse mode) less
    JᵀJ, in x's dtype."""
    def lagrangian(x, y, th):   # elementwise: forward-mode tangents can come back in float64
        r = residuals(x, th)
        return 0.5 * (r * r).sum() + (y * nlconstraints(x, th)).sum()

    hess = autodiff_jacobian(torch.func.grad(lagrangian))

    def curvature(x, y, th):
        J = jac_res(x, th).to(x.dtype)
        return hess(x, y, th) - J.mT @ J

    return curvature


# Base rank of each Polyhedron field; an extra leading axis marks it as
# per-instance (batched).
_POLY_BASE_RANK = Polyhedron(A=2, b=1, xl=1, xu=1)


def poly_batch_axes(poly: Polyhedron) -> tuple:
    """Per-field batch axis (0) or None for a Polyhedron with mixed
    shared/batched fields (the JAX `vmap` in_axes)."""
    return tuple(
        0 if getattr(poly, f).ndim > getattr(_POLY_BASE_RANK, f) else None
        for f in Polyhedron._fields
    )


def map_poly_fields(bp: BatchedProblem, fn) -> BatchedProblem:
    """Apply fn to the constraint fields (A/b/xl/xu) that carry a batch
    axis; shared fields pass through.  The slicing/gather helper for
    chunked and gathered sub-batches."""
    upd = {
        f: fn(getattr(bp, f))
        for f in ("A", "b", "xl", "xu")
        if getattr(bp, f) is not None
        and getattr(bp, f).ndim > getattr(_POLY_BASE_RANK, f)
    }
    return dataclasses.replace(bp, **upd) if upd else bp


def solve_batched(
    bp: BatchedProblem, theta, X0: Tensor, options: SolverOptions = SolverOptions(),
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Solve a batch of instances on X0's device; returns batched (X, Y, SolveInfo)."""
    B, n = X0.shape
    poly = bp.polyhedron(n, X0.dtype, B, X0.device)
    return solve_fixed_point(bp.instance_fns(theta), poly, X0, options)


def solve_batched_chunked(
    bp: BatchedProblem, theta, X0: Tensor, options: SolverOptions = SolverOptions(),
    chunk: int = 512,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Batched solve in chunks of at most `chunk` instances.

    A chunk's lockstep loops wait only for its own slowest instance.
    Per-lane results do not depend on `chunk`.  (The JAX version pads a
    ragged tail to a power of two to bound its compiled shapes; eager
    PyTorch compiles nothing, so the tail runs at its own size.)
    """
    B = X0.shape[0]
    chunk = max(min(chunk, B), 1)
    outs = []
    for start in range(0, B, chunk):
        sl = slice(start, min(start + chunk, B))
        outs.append(
            solve_batched(
                map_poly_fields(bp, lambda a: a[sl]),
                tree_map(lambda a: a[sl], theta),
                X0[sl],
                options,
            )
        )
    return cat_batches(outs)


def solve_sequential(
    bp: BatchedProblem, theta, X0: Tensor, options: SolverOptions = SolverOptions(),
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Loop-of-solves reference path: each instance alone, as a batch of
    one through `solve_fixed_point`.  The batched path is held to it."""
    one = lambda i: (lambda a: a[i:i + 1])
    return cat_batches([
        solve_batched(map_poly_fields(bp, one(i)), tree_map(one(i), theta), X0[i:i + 1], options)
        for i in range(X0.shape[0])
    ])
