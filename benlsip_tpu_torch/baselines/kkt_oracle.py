"""Independent first-principles KKT oracle of the port (numpy only).

The port's own copy of `kkt_check_point` and
`kkt_check_classic_battery` from the JAX package's
`baselines/kkt_oracle.py`: the port imports nothing of that package, not
even a module that needs only numpy.  `tests/test_torch_package.py` holds
the two copies to the same verdicts.  The check itself is numpy and shares
no code with the solver; the battery loop solves with the port's `solve`,
evaluates the port's callables at the solution and hands numpy arrays
over.

The solver certifies solutions with the exact-projection criticality
measure ‖P_Ω(x − ∇L) − x‖ (`ops/polyproject.py`).  This module checks the
KKT conditions of

    min ½‖r(x)‖²  s.t.  c(x) = 0,  Ax = b,  xl ≤ x ≤ xu

from first principles instead — multiplier estimation by LAPACK least
squares on the free coordinates, stationarity/sign/feasibility tests
directly on the definitions.  Nothing here touches the projection code
path: no dual Newton, no polyhedral projection, no shared kernels.

    L(x, y, ν, σ) = ½‖r‖² + yᵀc + νᵀ(Ax − b) − σ_loᵀ(x − xl) + σ_hiᵀ(x − xu)
    ∇ₓL = Jᵀr + Cᵀy + Aᵀν − σ_lo + σ_hi = 0
    σ_lo, σ_hi ≥ 0, complementary with the bound gaps.

On the free set F (strictly inside the box) the bound duals vanish, so
(y, ν) must solve the overdetermined system  [Cᵀ Aᵀ]_F μ = −(Jᵀr)_F ; the
oracle estimates μ by lstsq and checks the residual.  On active bounds the
implied dual σ = ±(Jᵀr + Eᵀμ)_i must carry the right sign.

A verdict that carries `degenerate_all_active` comes from the fully-active
branch, whose `lsq_linear` convergence is not checked (as in the JAX
package's copy); callers report how many verdicts carry it.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


def kkt_check_point(
    x: np.ndarray,
    r: np.ndarray,
    J: np.ndarray,
    c: Optional[np.ndarray],
    C: Optional[np.ndarray],
    A: Optional[np.ndarray],
    b: Optional[np.ndarray],
    xl: np.ndarray,
    xu: np.ndarray,
    stat_tol: float = 1.5e-8,
    feas_tol: float = 1.5e-8,
    active_atol: float = 1e-9,
) -> dict:
    """First-principles KKT check of one point; all inputs are numpy f64.

    Returns a dict with `ok` (bool) and the individual measures:
    `stat` (free-coordinate stationarity, scale-relative), `feas`
    (constraint violation), `bound_viol` (box violation), `sign_viol`
    (most negative implied bound dual, scale-relative).  Tolerances are
    scale-relative against 1 + ‖Jᵀr‖.
    """
    x = np.asarray(x, np.float64)
    r = np.asarray(r, np.float64)
    J = np.asarray(J, np.float64)
    n = x.shape[0]
    g = J.T @ r
    # Stationarity scales with the gradient; feasibility scales with the
    # CONSTRAINT data — gradient-scaled feasibility would certify gross
    # constraint violations on steep objectives.
    scale = 1.0 + float(np.linalg.norm(g))
    feas_scale = 1.0

    blocks = []
    feas2 = 0.0
    if C is not None and C.size:
        blocks.append(np.asarray(C, np.float64))
        feas2 += float(np.sum(np.asarray(c, np.float64) ** 2))
    if A is not None and A.size:
        blocks.append(np.asarray(A, np.float64))
        feas2 += float(np.sum((np.asarray(A, np.float64) @ x - np.asarray(b, np.float64)) ** 2))
        feas_scale += float(np.linalg.norm(np.asarray(b, np.float64)))
    E = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, n))
    feas = feas2 ** 0.5

    lo_gap = x - np.asarray(xl, np.float64)
    hi_gap = np.asarray(xu, np.float64) - x
    bound_viol = float(max(0.0, -min(lo_gap.min(initial=0.0), hi_gap.min(initial=0.0))))
    asc = active_atol * (1.0 + np.abs(x))
    on_lo = np.isfinite(xl) & (lo_gap <= asc)
    on_hi = np.isfinite(xu) & (hi_gap <= asc)
    free = ~(on_lo | on_hi)

    # Equality multipliers from the free stationarity rows (LAPACK lstsq —
    # min-norm for rank-deficient E, matching the solver's own convention).
    degenerate_all_active = False
    if E.shape[0] and free.any():
        mu, *_ = np.linalg.lstsq(E[:, free].T, -g[free], rcond=None)
    elif E.shape[0] and not free.any():
        # Fully-active box WITH equalities: there are no free stationarity
        # rows to pin mu, so mu=0 + a raw-gradient sign test can falsely
        # fail a genuine KKT point.  Estimate
        # (mu, sigma) jointly from the FULL stationarity rows with the
        # implied bound duals as sign-constrained slack:
        #     min ‖g + Eᵀmu − S sigma‖   s.t. sigma ≥ 0,
        # where S carries +e_i on lower-active and −e_i on upper-active
        # coords (both-bounds coords get an unsigned column).  A KKT point
        # has residual 0; the sign conditions hold by construction, so the
        # residual itself is the stationarity measure.
        both = on_lo & on_hi
        S_cols = []
        for i in range(n):
            col = np.zeros(n)
            col[i] = 1.0 if (on_lo[i] or both[i]) else -1.0
            S_cols.append(col)
        S = np.stack(S_cols, axis=1)  # (n, n): one dual column per coord
        try:
            from scipy.optimize import lsq_linear

            q = E.shape[0]
            M = np.concatenate([E.T, -S], axis=1)      # (n, q + n)
            lb = np.concatenate([np.full(q, -np.inf), np.zeros(n)])
            # Both-bounds coords carry either sign (degenerate box):
            lb[q:][np.asarray(both)] = -np.inf
            sol = lsq_linear(M, -g, bounds=(lb, np.full(q + n, np.inf)))
            mu = sol.x[:q]
            sigma = sol.x[q:]
            resid = g + E.T @ mu - S @ sigma
            return {
                "ok": bool(
                    float(np.linalg.norm(resid)) <= stat_tol * scale
                    and feas <= feas_tol * feas_scale
                    and bound_viol
                    <= feas_tol * (1.0 + float(np.max(np.abs(x), initial=0.0)))
                ),
                "stat": float(np.linalg.norm(resid)),
                "feas": feas,
                "bound_viol": bound_viol,
                "sign_viol": 0.0,  # enforced by the sigma >= 0 constraint
                "scale": scale,
                "n_free": 0,
                "n_eq": int(E.shape[0]),
                "degenerate_all_active": True,
            }
        except ImportError:  # pragma: no cover - scipy is present in-image
            mu = np.zeros((E.shape[0],))
            degenerate_all_active = True  # sign check unreliable; flag it
    else:
        mu = np.zeros((E.shape[0],))
    gL = g + (E.T @ mu if E.shape[0] else 0.0)

    stat = float(np.linalg.norm(gL[free])) if free.any() else 0.0
    # Implied bound duals: σ_lo = gL on lower-active (≥ 0), σ_hi = −gL on
    # upper-active (≥ 0).  Coordinates active at BOTH bounds (degenerate
    # box) carry either sign.
    both = on_lo & on_hi
    sign_viol = 0.0
    if not degenerate_all_active:
        if (on_lo & ~both).any():
            sign_viol = max(sign_viol, float(-(gL[on_lo & ~both]).min(initial=0.0)))
        if (on_hi & ~both).any():
            sign_viol = max(sign_viol, float((gL[on_hi & ~both]).max(initial=0.0)))

    bound_scale = 1.0 + float(np.max(np.abs(x), initial=0.0))
    ok = (
        stat <= stat_tol * scale
        and feas <= feas_tol * feas_scale
        and bound_viol <= feas_tol * bound_scale
        and sign_viol <= stat_tol * scale
    )
    out = {
        "ok": bool(ok),
        "stat": stat,
        "feas": feas,
        "bound_viol": bound_viol,
        "sign_viol": sign_viol,
        "scale": scale,
        "n_free": int(free.sum()),
        "n_eq": int(E.shape[0]),
    }
    if degenerate_all_active:  # scipy-less fallback: sign check skipped
        out["degenerate_all_active"] = True
    return out


def kkt_check_problem_point(problem, x, **tols) -> dict:
    """`kkt_check_point` of a `solver.api.Problem` at the tensor x (n,):
    r, J, c, C come from the problem's own callables on x's device and
    cross to the oracle as float64 numpy arrays."""
    import torch

    x = x.detach().to(torch.float64)
    fns, poly = problem.build(x.shape[0], torch.float64, x.device)
    f64 = lambda t: t[0].detach().cpu().numpy().astype(np.float64)
    X = x[None]
    c, C, A = f64(fns.nlconstraints(X)), f64(fns.jac_nlcons(X)), f64(poly.A)
    return kkt_check_point(
        f64(X), f64(fns.residuals(X)), f64(fns.jac_res(X)),
        c if c.size else None, C if C.size else None,
        A if A.size else None, f64(poly.b), f64(poly.xl), f64(poly.xu), **tols,
    )


def kkt_check_classic_battery(options=None, device=None) -> dict:
    """Solve every classic HS/MGH battery entry (problems/classic.py) in
    float64 on `device` (None: the CUDA card) and run the independent
    oracle on each solution.

    Returns the JAX package's keys {"battery_oracle_checked",
    "battery_oracle_agree", "battery_oracle_fail": [names]} and
    "battery_details": name → {x, converged, outer_iters, inner_iters,
    seconds, verdict} for callers that report per problem.
    """
    from ..problems.classic import REGISTRY
    from ..solver.api import solve
    from ..solver.options import SolverOptions

    fails, details = [], {}
    for name in sorted(REGISTRY):
        rec = REGISTRY[name]
        problem = rec.make_problem()
        opts = options or (
            SolverOptions(max_outer_iter=100, **rec.options)
            if rec.options
            else SolverOptions(max_outer_iter=100, max_inner_iter=300)
        )
        t0 = time.perf_counter()
        x, _, info = solve(problem, rec.x0(device=device), opts)
        converged = bool(info.converged)   # reading it waits for the device
        seconds = time.perf_counter() - t0
        verdict = kkt_check_problem_point(problem, x)
        details[name] = {
            "x": x.cpu().numpy(), "converged": converged, "outer_iters": int(info.outer_iters),
            "inner_iters": int(info.inner_iters), "seconds": seconds, "verdict": verdict,
        }
        if not (converged and verdict["ok"]):
            fails.append(name)
    return {
        "battery_oracle_checked": len(details),
        "battery_oracle_agree": len(details) - len(fails),
        "battery_oracle_fail": fails,
        "battery_details": details,
    }
