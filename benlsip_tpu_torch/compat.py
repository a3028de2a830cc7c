"""scipy.optimize-compatible entry points (PyTorch port of
`benlsip_tpu/compat.py`).

`least_squares` mirrors the call surface of
`scipy.optimize.least_squares` (fun/x0/jac/bounds/tolerances) so
bound-constrained NLS code written against scipy ports by changing one
import and writing `fun` with torch ops — and gains equality constraints
(`A_eq`/`b_eq` and `nl_eq` extensions) and the CUDA card underneath.  The
JAX entry's `jit=` argument is an XLA knob and is not carried.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ._device import as_tensor
from .solver.api import Problem, solve
from .solver.options import SolverOptions
from .solver.outer import SolveInfo

Tensor = torch.Tensor


@dataclasses.dataclass
class OptimizeResult:
    """scipy-shaped result object (attribute-compatible subset).

    `status` follows scipy's sign convention (positive = converged,
    0 = iteration limit, negative = failure); the framework's native
    codes live on `info.status`.  `optimality` is the exact
    projected-gradient KKT measure pi(x), stricter than scipy's
    first-order optimality for bound-only problems.
    """

    x: Tensor
    cost: float
    fun: Tensor
    jac: Tensor
    grad: Tensor
    optimality: float
    active_mask: Tensor
    nfev: int            # residual evaluations (one per inner TR candidate)
    njev: Optional[int]  # None: jacobian evals happen only on accepted steps
    nit: int
    status: int
    success: bool
    message: str
    info: SolveInfo

    def __repr__(self):  # compact, scipy-style
        return (
            f"OptimizeResult(success={self.success}, cost={self.cost:.6g}, "
            f"optimality={self.optimality:.3g}, nit={self.nit})"
        )


# OptimizeResult.status follows scipy's sign convention (status > 0 means
# convergence, 0 means the iteration limit, negative means failure) so
# ported code branching on `res.status > 0` keeps working.  The framework's
# own codes (solver/status.py: 1 converged, 2 max-outer, 3 stalled) remain
# available unchanged on `res.info.status`.
_STATUS_TO_SCIPY = {1: 1, 2: 0, 3: -2}
_MESSAGES = {
    1: "Convergence: KKT criticality and feasibility tolerances satisfied.",
    0: "Maximum number of outer iterations reached.",
    -2: "Stalled: criticality at its numerical floor above gtol.",
}


def least_squares(
    fun: Callable[..., Tensor],
    x0,
    jac: Optional[Callable[..., Tensor]] = None,
    bounds: Tuple[Any, Any] | Sequence[Any] = (-math.inf, math.inf),
    args: Tuple = (),
    gtol: Optional[float] = None,
    max_nfev: Optional[int] = None,
    A_eq=None,
    b_eq=None,
    nl_eq: Optional[Callable[[Tensor], Tensor]] = None,
    options: Optional[SolverOptions] = None,
    device=None,
) -> OptimizeResult:
    """Solve min ½‖fun(x)‖² with bounds (+ optional equality constraints).

    scipy-compatible subset: `fun(x, *args)` returns the residual vector
    (written with torch ops); `jac` its (d, n) Jacobian (autodiff when
    None); `bounds` is the scipy 2-tuple `(lb, ub)` of scalars or arrays,
    or a `scipy.optimize.Bounds`; `gtol` maps to the KKT criticality
    tolerance; `max_nfev` caps TR iterations per AL subproblem AND the
    number of subproblems (an exact total-evaluation budget does not map
    onto the two-level AL method — the realized count is returned as
    `nfev`).  An integer x0 is cast to float64, as scipy does; a tensor x0
    keeps its device, a list or numpy x0 is created on `device` (None: the
    CUDA card).

    Beyond scipy: `A_eq`/`b_eq` (linear equalities) and `nl_eq`
    (nonlinear equalities) pass straight through to the constrained
    solver.  For inequality constraints compose with `with_inequalities`
    first.
    """
    x0 = torch.atleast_1d(as_tensor(x0, device=device))
    n = x0.shape[0]
    kw = {"dtype": x0.dtype, "device": x0.device}

    if hasattr(bounds, "lb") and hasattr(bounds, "ub"):
        # scipy.optimize.Bounds instance; `keep_feasible` has no meaning
        # here: every iterate is feasible by construction.
        lb, ub = bounds.lb, bounds.ub
    else:
        lb, ub = bounds[0], bounds[1]
    xl = torch.broadcast_to(as_tensor(lb, **kw), (n,))
    xu = torch.broadcast_to(as_tensor(ub, **kw), (n,))

    residuals = (lambda x: fun(x, *args)) if args else fun
    jac_res = (lambda x: jac(x, *args)) if (jac and args) else jac

    opts = options or SolverOptions()
    updates = {}
    if gtol is not None:
        updates["crit_tol"] = gtol
    if max_nfev is not None:
        # Imperfect mapping onto a two-level AL method: this caps TR
        # candidates PER subproblem and the number of subproblems, so
        # total evaluations are bounded by the product, not by max_nfev
        # itself.  The actual count comes back as res.nfev.
        updates["max_inner_iter"] = int(max_nfev)
        updates["max_outer_iter"] = min(opts.max_outer_iter, int(max_nfev))
    if updates:
        opts = dataclasses.replace(opts, **updates)

    problem = Problem(
        residuals=residuals, jac_res=jac_res, nlconstraints=nl_eq,
        A=A_eq, b=b_eq, xl=xl, xu=xu,
    )
    x, y, info = solve(problem, x0, opts)

    fns, _ = problem.build(n, **kw)
    rx = fns.residuals(x[None])[0]
    J = fns.jac_res(x[None])[0]
    tol = torch.finfo(x0.dtype).eps ** 0.5 * (1 + torch.abs(x))
    active = torch.where(x - xl <= tol, -1, torch.where(xu - x <= tol, 1, 0))
    status = _STATUS_TO_SCIPY.get(int(info.status), -int(info.status))
    return OptimizeResult(
        x=x,
        cost=float(0.5 * torch.dot(rx, rx)),
        fun=rx,
        jac=J,
        grad=J.T @ rx,
        optimality=float(info.pix),
        active_mask=active,
        nfev=int(info.inner_iters) + 1,
        njev=None,
        nit=int(info.inner_iters),
        status=status,
        success=bool(info.converged),
        message=_MESSAGES.get(status, f"status {status}"),
        info=info,
    )
