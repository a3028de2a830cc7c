"""Outer augmented-Lagrangian driver (PyTorch port of `benlsip_tpu/solver/outer.py`).

LANCELOT-style outer loop: solve the TR subproblem to tolerance omega; if
the iterate is feasible enough (‖c‖ ≤ eta) accept it, update multipliers
and tighten both tolerances, otherwise raise the penalty and reset them;
converge when pi ≤ crit_tol and ‖c‖ ≤ feas_tol.  Tolerance floors and the
outer stall exit are carried over.  Batched: every lane runs its own
schedule; a lane stops updating when its own loop predicate is false.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._batched import full, norm, sel, vdot
from .._loops import host_rows, masked_while
from ..harness.logging import emit_outer_iter
from ..ops.al import _psum
from ..ops.constraints import Polyhedron
from .multipliers import first_order_multipliers, least_squares_multipliers
from .options import SolverOptions, matmul_precision
from .status import SOLVE_CONVERGED, SOLVE_MAX_OUTER, SOLVE_STALLED
from .subproblem import linear_gram_cache, solve_subproblem

Tensor = torch.Tensor


def initial_tolerances(mu, omega0, eta0, k_crit, k_feas):
    """omega = omega0/mu^k_crit, eta = eta0/mu^k_feas."""
    return omega0 / mu**k_crit, eta0 / mu**k_feas


def default_atol(dtype: torch.dtype) -> float:
    """The reference's sqrt(eps(T)) working tolerance."""
    return math.sqrt(torch.finfo(dtype).eps)


class SolveInfo(NamedTuple):
    """Per-lane diagnostics of a batched solve."""

    converged: Tensor
    status: Tensor
    outer_iters: Tensor
    inner_iters: Tensor
    pix: Tensor
    feas: Tensor
    mu: Tensor
    objective: Tensor
    minor_iters: Tensor
    cg_iters: Tensor


class OuterCarry(NamedTuple):
    x: Tensor
    y: Tensor
    mu: Tensor
    omega: Tensor
    eta: Tensor
    cx: Tensor
    pix: Tensor
    best_pix: Tensor
    stall: Tensor
    outer: Tensor
    inner_total: Tensor
    minor_total: Tensor
    cg_total: Tensor
    critical: Tensor


def outer_init(fns, poly: Polyhedron, x0: Tensor, opts: SolverOptions,
               y0: Optional[Tensor] = None) -> OuterCarry:
    """Initial carry: projection of x0, least-squares multipliers, tolerance schedule."""
    dtype = x0.dtype
    B = x0.shape[0]
    if opts.project_x0:
        from ..ops.polyproject import projection_polyhedron

        x0 = projection_polyhedron(poly, x0)
    cx0 = fns.nlconstraints(x0)
    mu0 = full(B, opts.mu0, x0)
    omega0, eta0 = initial_tolerances(mu0, opts.omega0, opts.eta0, opts.k_crit, opts.k_feas)
    use_qr_mult = opts.gn_factorization in ("qr", "cholqr2") or (
        opts.gn_factorization == "auto" and dtype in (torch.float32, torch.bfloat16)
    )
    if y0 is None:
        y0 = least_squares_multipliers(
            x0, fns, method="qr" if use_qr_mult else "normal", axis=opts.spmd_axis
        )
    else:
        y0 = y0.to(dtype)
    inf = full(B, float("inf"), x0)
    zero_i = full(B, 0, x0, torch.int32)
    return OuterCarry(
        x=x0, y=y0, mu=mu0, omega=omega0, eta=eta0, cx=cx0, pix=inf, best_pix=inf,
        stall=zero_i, outer=full(B, 1, x0, torch.int32), inner_total=zero_i,
        minor_total=zero_i, cg_total=zero_i, critical=full(B, False, x0, torch.bool),
    )


def outer_done(c: OuterCarry, opts: SolverOptions) -> Tensor:
    """Per-lane loop-termination predicate."""
    return c.critical | (c.outer > opts.max_outer_iter) | (c.stall >= opts.outer_stall_window)


def outer_body(fns, poly: Polyhedron, opts: SolverOptions, atol: float, c: OuterCarry,
               active: Optional[Tensor] = None, gram_cache: Optional[dict] = None) -> OuterCarry:
    """One outer AL iteration for every lane (`active` restricts the inner
    loops; `gram_cache` is the once-per-solve `linear_gram_cache`)."""
    # Tolerance floors: never demand more than the final tolerances.
    omega_eff = torch.clamp_min(c.omega, opts.crit_tol)
    eta_eff = torch.clamp_min(c.eta, opts.feas_tol)

    sub = solve_subproblem(
        fns, poly, c.x, c.y, c.mu, omega_eff, opts, atol, active=active, **(gram_cache or {})
    )
    feas = norm(sub.cx)

    accept = feas <= eta_eff
    critical = accept & (sub.pix <= opts.crit_tol) & (feas <= opts.feas_tol)

    x = sel(accept, sub.x, c.x)
    cx = sel(accept, sub.cx, c.cx)

    mu_next = torch.where(accept, c.mu, c.mu * opts.tau)
    update = accept & (~critical)
    y = sel(update, first_order_multipliers(c.y, sub.cx, c.mu), c.y)
    omega = torch.where(
        critical,
        c.omega,
        torch.where(update, c.omega / c.mu**opts.beta_crit, opts.omega0 / mu_next**opts.k_crit),
    )
    eta = torch.where(
        critical,
        c.eta,
        torch.where(update, c.eta / c.mu**opts.beta_feas, opts.eta0 / mu_next**opts.k_feas),
    )
    improved = sub.pix < opts.stall_ratio * c.best_pix
    at_floor = feas <= opts.feas_tol
    stall = torch.where(improved | ~at_floor, 0, c.stall + 1)

    if opts.verbose:
        # The table of each running lane, with the JAX package's columns.
        rxn = fns.residuals(x)
        run = torch.ones_like(accept) if active is None else active
        for row in host_rows(run, c.outer + 1, _psum(vdot(rxn, rxn), opts.spmd_axis), feas, mu_next, sub.pix, omega):
            emit_outer_iter(*row)
    return OuterCarry(
        x=x, y=y, mu=mu_next, omega=omega, eta=eta, cx=cx, pix=sub.pix,
        best_pix=torch.minimum(sub.pix, c.best_pix), stall=stall, outer=c.outer + 1,
        inner_total=c.inner_total + sub.inner_iters,
        minor_total=c.minor_total + sub.minor_iters,
        cg_total=c.cg_total + sub.cg_iters,
        critical=critical,
    )


def outer_loop(fns, poly: Polyhedron, opts: SolverOptions, atol: float, c: OuterCarry, run: Tensor,
               gram_cache: Optional[dict] = None) -> OuterCarry:
    """Outer iterations of the lanes in `run` until each is done (`outer`
    caps them at max_outer_iter)."""
    return masked_while(
        lambda c: ~outer_done(c, opts),
        lambda c, act: outer_body(fns, poly, opts, atol, c, active=act, gram_cache=gram_cache),
        c, run, opts.max_outer_iter + 1,
    )


def carry_info(out: OuterCarry, opts: SolverOptions, objective: Tensor) -> SolveInfo:
    return SolveInfo(
        converged=out.critical,
        status=torch.where(
            out.critical,
            SOLVE_CONVERGED,
            torch.where(out.stall >= opts.outer_stall_window, SOLVE_STALLED, SOLVE_MAX_OUTER),
        ).to(torch.int32),
        outer_iters=out.outer - 1,
        inner_iters=out.inner_total,
        pix=out.pix,
        feas=norm(out.cx),
        mu=out.mu,
        objective=objective,
        minor_iters=out.minor_total,
        cg_iters=out.cg_total,
    )


def final_multipliers(c: OuterCarry) -> Tensor:
    """The carry's multipliers as a solve returns them: at a critical exit
    the converged y + mu·c, else y."""
    return sel(c.critical, first_order_multipliers(c.y, c.cx, c.mu), c.y)


def finalize(fns, c: OuterCarry, opts: SolverOptions):
    """(X, Y, SolveInfo) of a carry: `final_multipliers`, and the objective
    ½‖r(x)‖².  Every caller that runs the outer loop (`solve_fixed_point`,
    `batch/compact`, `harness/checkpoint`) ends here; `batch/fused_small`'s
    bulk takes its Y from `final_multipliers`."""
    y_final = final_multipliers(c)
    rx = fns.residuals(c.x)
    return c.x, y_final, carry_info(c, opts, objective=_psum(0.5 * vdot(rx, rx), opts.spmd_axis))


def solve_fixed_point(fns, poly: Polyhedron, x0: Tensor, opts: SolverOptions,
                      y0: Optional[Tensor] = None):
    """Run the full TRALCNLLS iteration from x0 (B, n) for every lane;
    returns (X, Y, SolveInfo).  `fns` holds the batched callables.  The
    whole iteration runs under `opts.matmul_precision` (TF32 on the card
    for "default"), and the flag is restored on return or on an exception."""
    dtype = x0.dtype
    opts = opts.resolve_tols(dtype)
    atol = default_atol(dtype)

    with matmul_precision(opts.matmul_precision):
        c = outer_init(fns, poly, x0, opts, y0)
        # Constant-J problems: one JᵀJ product for the whole solve.
        gram_cache = linear_gram_cache(fns, c.x, opts)
        c = outer_loop(fns, poly, opts, atol, c, ~outer_done(c, opts), gram_cache)
        return finalize(fns, c, opts)
