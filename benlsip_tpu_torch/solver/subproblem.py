"""Trust-region subproblem solver (PyTorch port of `benlsip_tpu/solver/subproblem.py`).

Approximately minimizes the augmented Lagrangian over {Ax=b, xl ≤ x ≤ xu}
to criticality tolerance omega with trust-region steps from `inner_step`.
Batched: every lane runs its own trust-region loop; a lane stops updating
when its own predicate is false, and the Jacobian refresh on acceptance is
computed for the running lanes and selected per lane (the JAX `lax.cond`
under `vmap`).  When the Jacobian is tall the Hessian operator is
materialized once per refresh (`resolve_operator_route`) and the carry
holds it; `OPERATOR_BUILDS` counts those builds by route, so a caller can
see which operator a run really built.

Under `opts.spmd_axis` (the explicit-collective blocked mode) every rank
runs this loop on its own rows of J and r.  Each host-side loop decision
(`run.any()`, `upd.any()`) is made from values that are psummed or
computed from replicated data, so every rank takes every branch the same
way and meets every collective.  Outside eager mode (`_loops`) the
matrix-free refresh is computed unconditionally and selected per lane;
the materialized operator's is guarded by `_loops.branch_any` (an IF node
under capture, unconditional in "all_trips").
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Optional

import torch

from .._batched import full, norm, sel, sel_tuple
from .._loops import any_lane, branch_any, host_rows, masked_while, note
from ..harness.logging import emit_inner_iter
from ..ops.al import (
    AlHessian,
    al_gradient,
    evaluate_al,
    gram_j,
    gram_j_rows,
    new_point,
    with_gram,
    with_gram_rows,
    with_r_factor,
    with_r_factor_cholqr2,
)
from ..ops.constraints import ActiveSet, Polyhedron
from ..ops.project import norm_reduced_gradient
from ..ops.polyproject import projection_polyhedron
from .inner import inner_step
from .options import SolverOptions

Tensor = torch.Tensor

# Materialized-operator builds per (gn_factorization, dtype name) since the
# last `reset_operator_builds()`; the matrix-free route builds nothing.
# These count the Python calls: under CUDA-graph capture a call is a
# capture, not a run.  What the replays built is counted by the graphs'
# owner (`batch/fused_small.replay_counts()["operator_builds"]`, from the
# events `_loops.note`d here).
OPERATOR_BUILDS: Counter = Counter()


def reset_operator_builds() -> None:
    OPERATOR_BUILDS.clear()


def initial_tr(g: Tensor, tr_factor: float = 0.1) -> Tensor:
    """Initial radius tr_factor·‖g‖ per lane."""
    return tr_factor * norm(g)


def update_tr(delta: Tensor, rho: Tensor, eta1, eta2, gamma1, gamma2) -> Tensor:
    """Standard TR radius update; NaN rho keeps the radius."""
    return torch.where(rho > eta2, gamma2 * delta, torch.where(rho < eta1, gamma1 * delta, delta))


def reduced_gradient_measure(poly: Polyhedron, aset: ActiveSet, g: Tensor) -> Tensor:
    """‖P_T(−g)‖ per lane, the reference's reduced-gradient measure; kept
    for parity and diagnostics, not used for termination (see the JAX
    function)."""
    return norm_reduced_gradient(poly, aset, g)


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
    H: AlHessian
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
    """Shape/dtype-based operator route: (use_op, fact) — whether an (n, n)
    operator is materialized, and the resolved gn_factorization
    ("normal" / "qr" / "cholqr2").  Under `spmd_axis` `d_plus_p` counts
    this rank's rows, as in the JAX package."""
    ax = opts.spmd_axis
    use_op = opts.gram_hessian == "on" or (
        opts.gram_hessian == "auto" and n >= 64 and d_plus_p >= 2 * n
    )
    fact = opts.gn_factorization
    if fact == "auto":
        if dtype in (torch.float32, torch.bfloat16):
            # κ² eats the f32 budget: the orthogonal route, GEMM-shaped
            # CholeskyQR2 at large n or under an axis, the MGS kernel
            # behind qr_r at small n.
            fact = "cholqr2" if (ax is not None or n >= 64) else "qr"
        else:
            fact = "normal"
    if fact == "qr" and ax is not None:
        # No distributed Householder QR; an explicit request is refused,
        # never downgraded, whether or not the operator is materialized.
        raise ValueError(
            "gn_factorization='qr' (Householder) is unavailable under spmd_axis "
            "(the explicit-collective blocked mode).  Use gn_factorization='cholqr2', "
            "which reduces (n, n) Grams with one psum and never gathers J, or 'auto'."
        )
    return use_op, fact


def linear_gram_cache(fns, x0: Tensor, opts: SolverOptions) -> dict:
    """Constant-Jacobian JᵀJ cache for `opts.linear_residuals`, computed once
    per solve and handed to every subproblem as `Gj` (or, for the
    row-sharded Gram, `Gj_rows`); {} when the option is off or the route
    has nothing to cache (matrix-free, Householder QR)."""
    if not opts.linear_residuals:
        return {}
    J0 = fns.jac_res(x0)
    d_plus_p = J0.shape[-2] + fns.nlconstraints(x0).shape[-1]
    use_op, fact = resolve_operator_route(opts, x0.shape[-1], d_plus_p, x0.dtype)
    if not use_op or fact == "qr":
        return {}
    return _gram_cache(J0, fact, opts)


def _sharded_gram(fact: str, opts: SolverOptions) -> bool:
    return fact == "normal" and opts.spmd_axis is not None and opts.gram_layout == "sharded"


def _gram_cache(J: Tensor, fact: str, opts: SolverOptions) -> dict:
    if _sharded_gram(fact, opts):
        return {"Gj_rows": gram_j_rows(J, opts.spmd_axis, opts.reduce_schedule)}
    return {"Gj": gram_j(J, opts.spmd_axis)}


def _materializer(use_op: bool, fact: str, opts: SolverOptions, Gj: Optional[Tensor],
                  Gj_rows: Optional[Tensor]):
    ax = opts.spmd_axis
    if not use_op:
        return lambda H: H
    if fact == "qr":
        build = with_r_factor
    elif fact == "cholqr2":
        layout = opts.gram_layout if ax is not None else "replicated"
        build = lambda H: with_r_factor_cholqr2(H, ax, layout, Gj=Gj)
    elif _sharded_gram(fact, opts):
        build = lambda H: with_gram_rows(H, ax, opts.reduce_schedule, Gj_rows=Gj_rows)
    else:
        build = lambda H: with_gram(H, ax, Gj=Gj)

    def materialize(H: AlHessian) -> AlHessian:
        key = (fact, str(H.J.dtype).removeprefix("torch."))
        OPERATOR_BUILDS[key] += 1
        note(("operator_build",) + key)
        return build(H)

    return materialize


def solve_subproblem(
    fns, poly: Polyhedron, x0: Tensor, y: Tensor, mu: Tensor, omega_tol: Tensor,
    opts: SolverOptions, atol: float, active: Optional[Tensor] = None,
    Gj: Optional[Tensor] = None, Gj_rows: Optional[Tensor] = None,
) -> SubproblemResult:
    """Batched trust-region subproblem solve from x0 (B, n).

    `active` (B,) restricts the loop to the lanes an enclosing loop still
    runs; other lanes return their start point.  `Gj` / `Gj_rows` is the
    once-per-solve JᵀJ cache of `linear_gram_cache` (computed here when the
    option asks for it and none is given).
    """
    dtype = x0.dtype
    B, n = x0.shape
    ax = opts.spmd_axis
    rx0, cx0, _, mx0, g0, H0 = new_point(x0, y, mu, fns, ax)
    use_op, fact = resolve_operator_route(opts, n, rx0.shape[-1] + cx0.shape[-1], dtype)
    lin = opts.linear_residuals and use_op and fact != "qr"
    if lin and Gj is None and Gj_rows is None:
        cache = _gram_cache(H0.J, fact, opts)
        Gj, Gj_rows = cache.get("Gj"), cache.get("Gj_rows")
    if not lin:
        Gj = Gj_rows = None
    materialize = _materializer(use_op, fact, opts, Gj, Gj_rows)
    H0 = materialize(H0)
    delta0 = initial_tr(g0, opts.tr_factor)
    inf = full(B, float("inf"), mx0)
    zero_i = full(B, 0, mx0, torch.int32)
    c = _TRCarry(
        x=x0, rx=rx0, cx=cx0, mx=mx0, g=g0, H=H0, delta=delta0,
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
        s, pred, _aset, istats = inner_step(c.x, c.g, c.H, poly, c.delta, opts, atol, active=act)
        x_next = c.x + s
        rx_next, cx_next, mx_next = evaluate_al(x_next, y, mu, fns, ax)
        ared = mx_next - c.mx
        rho = ared / pred

        # Roundoff guard: when both reductions sit at the noise of mx, the
        # step counts as plainly successful.
        noise = 10.0 * torch.finfo(dtype).eps * torch.maximum(torch.abs(c.mx), torch.abs(mx_next))
        rho_noisy = (torch.abs(ared) <= noise) & (torch.abs(-pred) <= noise)
        rho = torch.where(rho_noisy, 0.5 * (opts.eta1 + opts.eta2), rho)
        accept = rho > opts.eta1

        if opts.verbose:
            # The row of each running lane: k, AL value, ‖s‖, Δ, ρ.
            for row in host_rows(act, c.k, c.mx, norm(s), c.delta, rho):
                emit_inner_iter(*row)

        # Derivatives (and the materialized operator) only on acceptance:
        # evaluated for the whole batch when a running lane accepts, the
        # other lanes keeping their Jacobians, and selected per lane.  A
        # materialized operator's rebuild sits behind an IF node under
        # capture (`branch_any`), so a replay skips it on the trips where
        # no lane accepts, as the eager loop does; the matrix-free refresh
        # is cheap enough to run unconditionally there (`any_lane`).
        upd = accept & act

        def refresh():
            Jn = sel(upd, fns.jac_res(x_next), c.H.J)
            Cn = sel(upd, fns.jac_nlcons(x_next), c.H.C)
            y_bar = y + mu.unsqueeze(-1) * cx_next
            return (sel(upd, al_gradient(Jn, Cn, rx_next, y_bar, ax), c.g),
                    sel_tuple(upd, materialize(AlHessian(Jn, Cn, mu)), c.H))

        if use_op:
            g, H = branch_any(upd, refresh, (c.g, c.H))
        else:
            g, H = refresh() if any_lane(upd) else (c.g, c.H)
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
            x, rx, cx, mx, g, H, delta, pix, crit_lam, best_pix, stall, c.k + 1,
            c.minor_total + istats.minor_iters, c.cg_total + istats.cg_iters, solved,
        )

    run = cond(c) if active is None else active & cond(c)
    c = masked_while(cond, body, c, run, opts.max_inner_iter)   # k caps the trips
    return SubproblemResult(
        x=c.x, rx=c.rx, cx=c.cx, pix=c.pix, inner_iters=c.k - 1,
        minor_iters=c.minor_total, cg_iters=c.cg_total,
    )
