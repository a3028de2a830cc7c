"""Trust-region subproblem solver (PyTorch port of `benlsip_tpu/solver/subproblem.py`).

Approximately minimizes the augmented Lagrangian over {Ax=b, xl ≤ x ≤ xu}
to criticality tolerance omega with trust-region steps from `inner_step`.
Batched: every lane runs its own trust-region loop; a lane stops updating
when its own predicate is false, and the Jacobian refresh on acceptance is
computed for the running lanes and selected per lane (the JAX `lax.cond`
under `vmap`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._batched import full, norm, sel, sel_tuple
from ..ops.al import AlHessian, al_gradient, evaluate_al, new_point
from ..ops.constraints import Polyhedron
from ..ops.polyproject import projection_polyhedron
from .inner import inner_step
from .options import SolverOptions

Tensor = torch.Tensor


def initial_tr(g: Tensor, tr_factor: float = 0.1) -> Tensor:
    """Initial radius tr_factor·‖g‖ per lane."""
    return tr_factor * norm(g)


def update_tr(delta: Tensor, rho: Tensor, eta1, eta2, gamma1, gamma2) -> Tensor:
    """Standard TR radius update; NaN rho keeps the radius."""
    return torch.where(rho > eta2, gamma2 * delta, torch.where(rho < eta1, gamma1 * delta, delta))


def criticality_measure(poly: Polyhedron, x: Tensor, g: Tensor, lam0: Optional[Tensor] = None,
                        active: Optional[Tensor] = None):
    """pi(x) = ‖P_Ω(x - g) - x‖ with the exact polyhedral projection, its
    dual warm-started from `lam0`.  Returns (pi, lam)."""
    p, lam = projection_polyhedron(poly, x - g, lam0=lam0, return_lam=True, active=active)
    return norm(p - x), lam


class _TRCarry(NamedTuple):
    x: Tensor
    rx: Tensor
    cx: Tensor
    mx: Tensor
    g: Tensor
    J: Tensor
    C: Tensor
    delta: Tensor
    pix: Tensor
    crit_lam: Tensor
    best_pix: Tensor
    stall: Tensor
    k: Tensor
    minor_total: Tensor
    cg_total: Tensor
    solved: Tensor


class SubproblemResult(NamedTuple):
    x: Tensor
    rx: Tensor
    cx: Tensor
    pix: Tensor
    inner_iters: Tensor
    minor_iters: Tensor
    cg_iters: Tensor


def resolve_operator_route(opts: SolverOptions, n: int, d_plus_p: int, dtype: torch.dtype):
    """Shape/dtype-based operator route: (use_op, fact).  Only the
    matrix-free route (use_op False) is ported; a resolution that would
    materialize an (n, n) operator raises."""
    use_op = opts.gram_hessian == "on" or (
        opts.gram_hessian == "auto" and n >= 64 and d_plus_p >= 2 * n
    )
    fact = opts.gn_factorization
    if fact == "auto":
        if dtype in (torch.float32, torch.bfloat16):
            fact = "cholqr2" if n >= 64 else "qr"
        else:
            fact = "normal"
    if use_op:
        raise NotImplementedError(
            f"materialized Gauss-Newton operator ({fact}) at n={n}: not ported to "
            "benlsip_tpu_torch yet (only the matrix-free route)"
        )
    return use_op, fact


def solve_subproblem(
    fns, poly: Polyhedron, x0: Tensor, y: Tensor, mu: Tensor, omega_tol: Tensor,
    opts: SolverOptions, atol: float, active: Optional[Tensor] = None,
) -> SubproblemResult:
    """Batched trust-region subproblem solve from x0 (B, n).

    `active` (B,) restricts the loop to the lanes an enclosing loop still
    runs; other lanes return their start point.
    """
    dtype = x0.dtype
    B, n = x0.shape
    rx0, cx0, _, mx0, g0, H0 = new_point(x0, y, mu, fns)
    resolve_operator_route(opts, n, rx0.shape[-1] + cx0.shape[-1], dtype)
    delta0 = initial_tr(g0, opts.tr_factor)
    inf = full(B, float("inf"), mx0)
    zero_i = full(B, 0, mx0, torch.int32)
    c = _TRCarry(
        x=x0, rx=rx0, cx=cx0, mx=mx0, g=g0, J=H0.J, C=H0.C, delta=delta0,
        pix=inf,
        crit_lam=torch.zeros_like(poly.b),
        best_pix=inf,
        stall=zero_i,
        k=full(B, 1, mx0, torch.int32),
        minor_total=zero_i,
        cg_total=zero_i,
        solved=full(B, False, mx0, torch.bool),
    )

    def cond(c: _TRCarry):
        return (~c.solved) & (c.k <= opts.max_inner_iter) & (c.stall < opts.stall_window)

    def body(c: _TRCarry, act: Tensor) -> _TRCarry:
        H = AlHessian(c.J, c.C, mu)
        s, pred, _aset, istats = inner_step(c.x, c.g, H, poly, c.delta, opts, atol, active=act)
        x_next = c.x + s
        rx_next, cx_next, mx_next = evaluate_al(x_next, y, mu, fns)
        ared = mx_next - c.mx
        rho = ared / pred

        # Roundoff guard: when both reductions sit at the noise of mx, the
        # step counts as plainly successful.
        noise = 10.0 * torch.finfo(dtype).eps * torch.maximum(torch.abs(c.mx), torch.abs(mx_next))
        rho_noisy = (torch.abs(ared) <= noise) & (torch.abs(-pred) <= noise)
        rho = torch.where(rho_noisy, 0.5 * (opts.eta1 + opts.eta2), rho)
        accept = rho > opts.eta1

        # Derivatives only on acceptance: evaluated for the running lanes
        # and selected per lane.
        Jn = fns.jac_res(x_next)
        Cn = fns.jac_nlcons(x_next)
        y_bar = y + mu.unsqueeze(-1) * cx_next
        gn = al_gradient(Jn, Cn, rx_next, y_bar)

        g = sel(accept, gn, c.g)
        J = sel(accept, Jn, c.J)
        C = sel(accept, Cn, c.C)
        x = sel(accept, x_next, c.x)
        rx = sel(accept, rx_next, c.rx)
        cx = sel(accept, cx_next, c.cx)
        mx = torch.where(accept, mx_next, c.mx)

        delta = update_tr(c.delta, rho, opts.eta1, opts.eta2, opts.gamma1, opts.gamma2)
        pix, crit_lam = criticality_measure(poly, x, g, lam0=c.crit_lam, active=act)
        solved = pix < omega_tol
        improved = pix < opts.stall_ratio * c.best_pix
        best_pix = torch.minimum(pix, c.best_pix)
        stall = torch.where(improved, 0, c.stall + 1)
        return _TRCarry(
            x, rx, cx, mx, g, J, C, delta, pix, crit_lam, best_pix, stall, c.k + 1,
            c.minor_total + istats.minor_iters, c.cg_total + istats.cg_iters, solved,
        )

    run = cond(c) if active is None else active & cond(c)
    while bool(run.any()):
        c = sel_tuple(run, body(c, run), c)
        run = run & cond(c)
    return SubproblemResult(
        x=c.x, rx=c.rx, cx=c.cx, pix=c.pix, inner_iters=c.k - 1,
        minor_iters=c.minor_total, cg_iters=c.cg_total,
    )
