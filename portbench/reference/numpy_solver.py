"""Frozen copy of the port's single-core NumPy solver (the
`project_polyhedron_np`, `_kkt_step` and `solve_one_numpy` of
`benlsip_tpu_torch/baselines/numpy_ref.py`), so that later changes to the
port's baselines do not move the benchmark's reference.

Pure NumPy: augmented-Lagrangian outer loop around a Levenberg-Marquardt
inner loop with active-set bound handling and masked equality-KKT solves,
certified with the exact-projection criticality ‖P_Ω(x − ∇L) − x‖.  It
shares no code with the solver under test.
"""
from __future__ import annotations

import numpy as np

_SQEPS = float(np.sqrt(np.finfo(np.float64).eps))


def project_polyhedron_np(z, A, b, xl, xu, tol=1e-12, max_iter=100):
    """argmin ‖v − z‖² s.t. Av = b, xl ≤ v ≤ xu (pure numpy).

    Damped dual semismooth Newton on the equality multipliers lam (m is
    small): v(lam) = clip(z − Aᵀlam), residual F = A v(lam) − b,
    generalized Jacobian −A D Aᵀ with D = diag(strictly-inside mask).
    Same algorithm as the in-framework jittable projector
    (ops/polyproject.py), restated with dynamic shapes for host use —
    including the exact linesearch on the concave dual: the undamped
    iteration oscillates between clip faces for far-away points, so each
    Newton direction is stepped to the root of the dual slope
    phi(t) = wᵀ clip(z0 − t·w, l, u) − dᵀb (non-increasing in t).
    """
    m = A.shape[0]
    if m == 0:
        return np.clip(z, xl, xu)
    lam = np.zeros(m)
    reg = 1e-12
    for _ in range(max_iter):
        z0 = z - A.T @ lam
        v = np.clip(z0, xl, xu)
        F = A @ v - b
        if np.linalg.norm(F, ord=np.inf) <= tol:
            break
        inside = ((z0 > xl) & (z0 < xu)).astype(float)
        Jd = (A * inside[None, :]) @ A.T
        Jd[np.diag_indices_from(Jd)] += reg
        d = np.linalg.solve(Jd, F)
        w = A.T @ d
        db = float(d @ b)

        def phi(t):
            return float(w @ np.clip(z0 - t * w, xl, xu)) - db

        # Bracket the root of the non-increasing slope, then bisect.
        t_hi = 1.0
        for _ in range(60):
            if phi(t_hi) <= 0.0:
                break
            t_hi *= 2.0
        t_lo = 0.0
        for _ in range(80):
            t_mid = 0.5 * (t_lo + t_hi)
            if phi(t_mid) > 0.0:
                t_lo = t_mid
            else:
                t_hi = t_mid
            if t_hi - t_lo <= 1e-12 * max(t_hi, 1.0):
                break
        lam = lam + 0.5 * (t_lo + t_hi) * d
    return np.clip(z - A.T @ lam, xl, xu)


def _kkt_step(J, r, E, e, fixed, lam_lm):
    """One damped GN/LM step with fixed-set masking (dense KKT solve).

    Solves [ZJᵀJZ + lam·Z + diag(fixed), (EZ)ᵀ; EZ, 0] [dx; nu] =
    [−Z Jᵀ r; −e]; fixed rows read dx_i = 0 exactly.
    """
    n = J.shape[1]
    q = E.shape[0]
    free = (~fixed).astype(float)
    JZ = J * free[None, :]
    EZ = E * free[None, :]
    H = JZ.T @ JZ
    H[np.diag_indices_from(H)] += lam_lm * free + fixed.astype(float)
    K = np.zeros((n + q, n + q))
    K[:n, :n] = H
    K[:n, n:] = EZ.T
    K[n:, :n] = EZ
    K[n:, n:] = -1e-14 * np.eye(q)
    rhs = np.concatenate([-(free * (J.T @ r)), -e])
    try:
        sol = np.linalg.solve(K, rhs)
    except np.linalg.LinAlgError:
        sol = np.linalg.lstsq(K, rhs, rcond=None)[0]
    return sol[:n] * free, sol[n:]




def solve_one_numpy(
    residuals,
    jac_res,
    nlconstraints,
    jac_nlcons,
    A,
    b,
    xl,
    xu,
    x0,
    crit_tol=_SQEPS,
    feas_tol=_SQEPS,
    mu0=10.0,
    tau=100.0,
    max_outer=40,
    max_inner=200,
    active_tol=1e-9,
    step_rule="boundary",
):
    """Single-instance constrained-NLS solve, pure numpy, single core.

    residuals/jac_res/nlconstraints/jac_nlcons: numpy callables of x.
    Returns (x, y, info dict with pix/feas/converged/inner_evals).

    step_rule: how a KKT step that leaves the box is handled.
    "boundary" (default) steps fraction-to-boundary — preserves Ax = b
    exactly, required once many bounds are active (config-3 scale: ~85/192
    coords at a bound, where clipping breaks linear feasibility faster
    than the KKT correction restores it).  "clip" projects the full step
    into the box and lets the next KKT solve's −e term heal the small
    Ax − b violation — fewer, longer steps, measurably faster on tiny-n
    families with few active bounds (config 2: 225/s vs 98/s), and
    certified by the same exact-projection oracle either way.  Each
    workload's baseline uses the FASTER rule that certifies, which is the
    honest direction to err in.
    """
    n = x0.size
    m = A.shape[0]
    x = project_polyhedron_np(x0, A, b, xl, xu)
    c0 = nlconstraints(x)
    p = c0.size
    y = np.zeros(p)
    mu = mu0
    nfev = 0

    def al_fns(x, y, mu):
        r = residuals(x)
        c = nlconstraints(x)
        # AL as an NLS: stacked residuals [r; sqrt(mu) (c + y/mu)] have
        # the AL's gradient/GN Hessian (constant offset in the value).
        if p:
            raug = np.concatenate([r, np.sqrt(mu) * (c + y / mu)])
        else:
            raug = r
        return raug, c

    def al_jac(x, mu):
        J = jac_res(x)
        if p:
            return np.vstack([J, np.sqrt(mu) * jac_nlcons(x)])
        return J

    # LANCELOT tolerance schedule (the reference's, ref :153-163, :273-289):
    # loose inner criticality omega and feasibility gate eta early, tighten
    # on accepted (feasible-enough) outer iterations, reset on penalty
    # escalations.  Without the schedule mu explodes while y never updates
    # and the inner AL problem becomes unsolvably stiff.
    omega = 1.0 / mu
    eta = 1.0 / mu**0.1
    for _ in range(max(max_outer, 1) if p else 1):
        # --- inner: LM with active-set bounds on min ½‖raug(x)‖² s.t. Ax=b, box
        lam_lm = 1e-4
        raug, c = al_fns(x, y, mu)
        J = al_jac(x, mu)
        nfev += 1
        fx = 0.5 * float(raug @ raug)
        inner_tol = max(omega, 0.3 * crit_tol) if p else 0.3 * crit_tol
        for _ in range(max_inner):
            e = A @ x - b
            gL = J.T @ raug
            at_lo = np.isfinite(xl) & (x - xl <= active_tol * (1.0 + np.abs(x)))
            at_hi = np.isfinite(xu) & (xu - x <= active_tol * (1.0 + np.abs(x)))
            fixed = (at_lo & (gL > 0)) | (at_hi & (gL < 0))
            # Projected-gradient criticality on the AL (cheap inner test).
            pg = project_polyhedron_np(x - gL, A, b, xl, xu) - x
            if np.linalg.norm(pg) <= inner_tol:
                break
            if step_rule == "clip":
                dx, _nu = _kkt_step(J, raug, A, e, fixed, lam_lm)
                xn = np.clip(x + dx, xl, xu)
            else:
                # Fraction-to-boundary step: stepping to the first blocking
                # bound (instead of clipping x + dx into the box) preserves
                # Ax = b exactly.  A coordinate sitting on its bound with
                # the step pushing outward blocks at t = 0: fix it and
                # re-solve.
                for _ in range(8):
                    dx, _nu = _kkt_step(J, raug, A, e, fixed, lam_lm)
                    blocked = ((x - xl <= active_tol * (1.0 + np.abs(x))) & (dx < 0)) | (
                        (xu - x <= active_tol * (1.0 + np.abs(x))) & (dx > 0)
                    )
                    if not blocked.any():
                        break
                    fixed = fixed | blocked
                t = 1.0
                pos = dx > 1e-300
                neg = dx < -1e-300
                if pos.any():
                    t = min(t, float(np.min((xu[pos] - x[pos]) / dx[pos])))
                if neg.any():
                    t = min(t, float(np.min((xl[neg] - x[neg]) / dx[neg])))
                t = max(t, 0.0)
                xn = np.clip(x + t * dx, xl, xu)  # clip only cleans roundoff
            raug_n, c_n = al_fns(xn, y, mu)
            nfev += 1
            fn = 0.5 * float(raug_n @ raug_n)
            if fn < fx:
                x, raug, c, fx = xn, raug_n, c_n, fn
                J = al_jac(x, mu)
                lam_lm = max(lam_lm * 0.33, 1e-12)
                if np.linalg.norm(dx) <= 1e-15 * (1.0 + np.linalg.norm(x)):
                    break
            else:
                lam_lm = min(lam_lm * 8.0, 1e8)
                if lam_lm >= 1e8:
                    break
        if p == 0:
            break
        feas = np.linalg.norm(c)
        if feas <= max(eta, feas_tol):
            # Accept: first-order multiplier update + tolerance tightening.
            y = y + mu * c
            gL0 = jac_res(x).T @ residuals(x) + jac_nlcons(x).T @ y
            pix0 = np.linalg.norm(project_polyhedron_np(x - gL0, A, b, xl, xu) - x)
            if pix0 <= crit_tol and feas <= feas_tol:
                break
            omega = max(omega / mu, 0.3 * crit_tol)
            eta = max(eta / mu**0.9, feas_tol)
        else:
            mu = mu * tau
            omega = 1.0 / mu
            eta = 1.0 / mu**0.1

    # Final certification with the exact-projection oracle.
    r = residuals(x)
    c = nlconstraints(x)
    if p:
        gL = jac_res(x).T @ r + jac_nlcons(x).T @ y
    else:
        gL = jac_res(x).T @ r
    pix = np.linalg.norm(project_polyhedron_np(x - gL, A, b, xl, xu) - x)
    feas = float(np.sqrt(np.sum(c * c) + np.sum((A @ x - b) ** 2)))
    return x, y, {
        "pix": float(pix),
        "feas": feas,
        "converged": bool(pix <= 10 * crit_tol and feas <= 10 * feas_tol),
        "nfev": nfev,
    }
