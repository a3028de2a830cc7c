"""Frozen copy of the port's first-principles KKT oracle
(`kkt_check_point` of `benlsip_tpu_torch/baselines/kkt_oracle.py`), so
that later changes to the port's baselines do not move the benchmark's
reference.

It checks the KKT conditions of

    min ½‖r(x)‖²  s.t.  c(x) = 0,  Ax = b,  xl ≤ x ≤ xu

from their definitions: equality multipliers by LAPACK least squares on
the free coordinates, then stationarity, the signs of the implied bound
duals and feasibility, each against a scale-relative tolerance.  No
projection and no code of the solver under test.
"""
from __future__ import annotations

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
