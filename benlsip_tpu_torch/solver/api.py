"""Public solver API (PyTorch port of `benlsip_tpu/solver/api.py`).

Two surfaces for one instance:

* `tralcnllss(...)` — positional-argument mirror of the reference's only
  exported symbol, returning (x, y) plus a `SolveInfo`.
* `solve(problem, x0, options)` — the idiomatic entry: a `Problem` bundles
  per-instance callables of x (n,) and constraint data; Jacobians default
  to `torch.func.jacfwd`.

The solver underneath is batch-first: every `NLSFunctions` callable takes
X (B, n) and returns the batch's residuals (B, d), constraints (B, p) or
Jacobians (B, d, n) / (B, p, n).  `Problem.build` lifts the per-instance
callables with `torch.func.vmap`, and `solve` runs the batch of one.  For
batches of instances use `benlsip_tpu_torch.batch.vmap_solve`.

`device=None` is the CUDA card (`_device.resolve_device`); an x0 that is
already a tensor keeps its device.  The JAX entry's `jit=` argument is an
XLA knob and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional, Tuple

import torch

from .._device import as_tensor
from ..ops.constraints import Polyhedron, is_feasible  # noqa: F401  (re-export)
from .options import SolverOptions
from .outer import SolveInfo, solve_fixed_point

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NLSFunctions:
    """Batched callables of an NLS problem family (p may be 0)."""

    residuals: Callable[[Tensor], Tensor]
    nlconstraints: Callable[[Tensor], Tensor]
    jac_res: Callable[[Tensor], Tensor]
    jac_nlcons: Callable[[Tensor], Tensor]


# Forward-mode AD levels are global to the process, not to a thread: two
# threads inside `jacfwd` at once corrupt each other's levels (the
# overlapped pipeline certifies on a worker thread while the main thread
# runs the bulk), so Jacobian evaluations take turns.
_FORWARD_AD = threading.RLock()


def autodiff_jacobian(fn: Callable) -> Callable:
    """Forward-mode Jacobian of a per-instance fn(x, *args) in x, in x's
    dtype: `torch.func.jacfwd` can hand back a float64 Jacobian for a
    float32 x when fn mixes an indexed coordinate with a Python float."""
    jac = torch.func.jacfwd(fn)

    def jac_in_x_dtype(x, *args):
        with _FORWARD_AD:
            return jac(x, *args).to(x.dtype)

    return jac_in_x_dtype


def empty_nlconstraints(X: Tensor) -> Tensor:
    """c(X) of a family without nonlinear constraints: (B, 0)."""
    return X.new_zeros((X.shape[0], 0))


def empty_jac_nlcons(X: Tensor) -> Tensor:
    """Its Jacobian, (B, 0, n); no autodiff of a zero-output function."""
    return X.new_zeros((X.shape[0], 0, X.shape[1]))


@dataclasses.dataclass(frozen=True)
class Problem:
    """A constrained NLS instance: min ½‖r(x)‖² s.t. c(x)=0, Ax=b, xl ≤ x ≤ xu.

    The callables are per-instance functions of x (n,) written with torch
    ops; a Jacobian left None comes from autodiff.  A, b, xl, xu may be
    tensors, numpy arrays or lists: `build` casts them to the solve's
    dtype and device.
    """

    residuals: Callable[[Tensor], Tensor]
    nlconstraints: Optional[Callable[[Tensor], Tensor]] = None
    jac_res: Optional[Callable[[Tensor], Tensor]] = None
    jac_nlcons: Optional[Callable[[Tensor], Tensor]] = None
    A: Optional[Any] = None
    b: Optional[Any] = None
    xl: Optional[Any] = None
    xu: Optional[Any] = None

    def build(self, n: int, dtype: torch.dtype, device) -> Tuple[NLSFunctions, Polyhedron]:
        """Normalize to (batched NLSFunctions, Polyhedron of a batch of
        one), filling defaults: autodiff Jacobians, empty constraint
        blocks, infinite bounds."""
        vmap = torch.func.vmap
        if self.nlconstraints is None:
            nlc, jc = empty_nlconstraints, empty_jac_nlcons
        else:
            nlc = vmap(self.nlconstraints)
            jc = vmap(self.jac_nlcons or autodiff_jacobian(self.nlconstraints))
        fns = NLSFunctions(
            residuals=vmap(self.residuals),
            nlconstraints=nlc,
            jac_res=vmap(self.jac_res or autodiff_jacobian(self.residuals)),
            jac_nlcons=jc,
        )
        kw = {"dtype": dtype, "device": device}
        A = as_tensor(self.A, **kw) if self.A is not None else torch.zeros((0, n), **kw)
        b = as_tensor(self.b, **kw) if self.b is not None else torch.zeros((A.shape[0],), **kw)
        xl = as_tensor(self.xl, **kw) if self.xl is not None else torch.full((n,), -float("inf"), **kw)
        xu = as_tensor(self.xu, **kw) if self.xu is not None else torch.full((n,), float("inf"), **kw)
        return fns, Polyhedron(A=A[None], b=b[None], xl=xl[None], xu=xu[None])


def solve(
    problem: Problem,
    x0,
    options: SolverOptions = SolverOptions(),
    y0=None,
    device=None,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Solve a constrained NLS problem from x0; returns (x (n,), y (p,),
    info) with every field of `info` a 0-dim tensor.

    x0 may be a tensor (the solve runs on its device), a numpy array or a
    list (created on `device`; None is the CUDA card).  `y0` warm-starts
    the nonlinear-constraint multipliers — continuation and parameter
    sweeps reuse the previous solve's y to skip the early
    multiplier-correction outer iterations; None computes the
    least-squares estimate.
    """
    x0 = as_tensor(x0, device=device)
    fns, poly = problem.build(x0.shape[0], x0.dtype, x0.device)
    Y0 = None if y0 is None else as_tensor(y0, dtype=x0.dtype, device=x0.device)[None]
    X, Y, info = solve_fixed_point(fns, poly, x0[None], options, Y0)
    return X[0], Y[0], SolveInfo(*[f[0] for f in info])


def tralcnllss(
    x0,
    residuals: Callable[[Tensor], Tensor],
    jac_res: Callable[[Tensor], Tensor],
    nlconstraints: Callable[[Tensor], Tensor],
    jac_nlcons: Callable[[Tensor], Tensor],
    A,
    b,
    x_l,
    x_u,
    device=None,
    **options,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Reference-parity entry point: the reference's positional order and
    keyword hyperparameter names; returns (x, y, info) where the reference
    returns (x, y)."""
    problem = Problem(
        residuals=residuals,
        nlconstraints=nlconstraints,
        jac_res=jac_res,
        jac_nlcons=jac_nlcons,
        A=A,
        b=b,
        xl=x_l,
        xu=x_u,
    )
    return solve(problem, x0, SolverOptions(**options), device=device)
