"""Single-core numpy constrained-NLS solver: the sweep's measured baseline
(the port's own copy of `benlsip_tpu/baselines/numpy_ref.py`).

The port imports nothing of the JAX package, not even a module that needs
only numpy, so it keeps this copy; `tests/test_torch_numpy_ref.py` holds
the two to the same outputs.  The reference (BEnlsip.jl) publishes no
performance numbers, so the benchmarks need a stand-in for "the
reference's execution model": ONE core, dynamic shapes, direct dense
linear algebra, no framework dispatch in the hot loop.  This module is
that stand-in — pure numpy (BLAS-backed, like Julia's LinearAlgebra), no
torch anywhere, written the way a performance-aware user of the reference
would hand-code the same solve.

Algorithm: augmented-Lagrangian outer loop (the reference's TRALCNLLS
schedule, `src/basic_tralcnlss.jl:167-298` of BEnlsip.jl) around a
Levenberg-Marquardt inner loop with semismooth active-set bound handling
and masked equality-KKT solves (the dense small-n specialization of the
same mathematics — for n ≤ ~20 a direct KKT solve per iteration is
strictly faster single-core than the reference's Cauchy-walk + projected
CG, so this baseline is *stronger* than a literal transcription, which is
the honest direction to err in).  Convergence is certified with the same
oracle as everything else in this repo: exact-projection criticality
‖P_Ω(x − ∇L) − x‖ ≤ tol plus feasibility (the reference's own KKT check,
ref `test/problems/sphere_regression.jl:58-65`), with P_Ω computed by a
semismooth dual Newton on the m linear-equality multipliers.
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


def solve_family_numpy(
    make_instance, B, A, b, xl, xu, X0, crit_tol=_SQEPS, b_per_instance=None,
    step_rule="boundary",
):
    """Sequential single-core solve of a problem family (generic driver).

    `make_instance(i)` returns the numpy callables
    (residuals, jac_res, nlconstraints, jac_nlcons) for instance i — the
    BatchedProblem-style factory restated for host numpy (BASELINE.md
    measurement contract: the baseline must execute the reference's model —
    one core, dynamic shapes, no framework dispatch).  Returns
    (X, conv_count, total_nfev).
    """
    X = np.empty_like(X0)
    conv = 0
    nfev = 0
    for i in range(B):
        residuals, jac_res, nlconstraints, jac_nlcons = make_instance(i)
        bi = b_per_instance[i] if b_per_instance is not None else b
        xi, _, info = solve_one_numpy(
            residuals, jac_res, nlconstraints, jac_nlcons, A, bi, xl, xu, X0[i],
            crit_tol=crit_tol, step_rule=step_rule,
        )
        X[i] = xi
        conv += int(info["converged"])
        nfev += info["nfev"]
    return X, conv, nfev


def solve_dense_lsq_numpy(J, Y, A, b, xl, xu, X0, crit_tol=_SQEPS):
    """Single-core numpy baseline for the config-3 workload
    (dense_quadratic_family: r(x) = J x − y, shared J, per-instance
    targets, linear equalities + active-at-solution bounds) — the dense
    medium-n counterpart of `solve_exp_fit_numpy`, closing the round-2
    gap where configs 3/5 had no measured external baseline.

    Returns (X, conv_count).
    """
    n = J.shape[1]
    no_nl = lambda x: np.zeros(0)
    no_nl_jac = lambda x: np.zeros((0, n))

    def make_instance(i):
        yi = Y[i]
        return (lambda x: J @ x - yi), (lambda x: J), no_nl, no_nl_jac

    X, conv, _ = solve_family_numpy(
        make_instance, Y.shape[0], A, b, xl, xu, X0, crit_tol=crit_tol
    )
    return X, conv


def solve_exp_fit_numpy(theta_t, theta_y, A, b_all, xl, xu, X0, crit_tol=_SQEPS):
    """Sequential single-core solve of the bench's config-2 workload
    (exp_fit_family: y ≈ a·exp(−b t) + c, bounds + one linear equality),
    with the model hand-coded in numpy — what a reference user would run.

    theta_t/theta_y: (B, d); b_all: (B, 1) per-instance rhs; X0: (B, 3).
    Returns (X, conv_count).
    """
    B = theta_y.shape[0]
    X = np.empty_like(X0)
    conv = 0
    no_nl = lambda x: np.zeros(0)
    no_nl_jac = lambda x: np.zeros((0, 3))
    for i in range(B):
        t, yv = theta_t[i], theta_y[i]

        def residuals(x):
            return x[0] * np.exp(-x[1] * t) + x[2] - yv

        def jac(x):
            ex = np.exp(-x[1] * t)
            return np.stack([ex, -x[0] * t * ex, np.ones_like(t)], axis=1)

        xi, _, info = solve_one_numpy(
            residuals, jac, no_nl, no_nl_jac, A, b_all[i], xl, xu, X0[i],
            crit_tol=crit_tol, step_rule="clip",
        )
        X[i] = xi
        conv += int(info["converged"])
    return X, conv


def solve_blocked_numpy(
    J0, y, A, b, xl, xu, x0, alpha=0.5,
    crit_tol=_SQEPS, feas_tol=_SQEPS,
    max_outer=30, max_inner=60, max_cg=200,
    mu0=10.0, tau=100.0,
):
    """Single-core matrix-free baseline for the config-4 blocked workload
    (VERDICT r4 #5): min ½‖J0·psi(x) − y‖² s.t. Ax = b, xl ≤ x ≤ xu with
    psi(x) = x + alpha·x³ (problems/generators.blocked_hard_family).

    At n ≈ 10k a dense factorization is 1e12+ flops per step, so the
    performance-aware single-core formulation is the same mathematics the
    framework runs: an augmented-Lagrangian outer loop (the reference's
    LANCELOT schedule, ref `src/basic_tralcnlss.jl:167-298`) around a
    bound-constrained projected Gauss-Newton/CG inner loop — every hot op
    a BLAS-2 J0 matvec (2dn flops), no (n, n) matrix ever formed.
    Certification: exact-projection criticality + feasibility, same
    oracle as everything else in this repo.

    Returns (x, {"converged", "pix", "feas", "outer", "inner", "cg"}).
    """
    x = np.clip(np.asarray(x0, np.float64).copy(), xl, xu)
    J0 = np.asarray(J0, np.float64)
    y = np.asarray(y, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    nu = np.zeros(A.shape[0])
    mu = mu0
    omega, eta = 1.0 / mu, 1.0 / mu**0.1
    inner_total = cg_total = 0

    def merit(x):
        r = J0 @ (x + alpha * x**3) - y
        e = A @ x - b
        return 0.5 * r @ r + nu @ e + 0.5 * mu * e @ e

    pix = feas = np.inf
    outer = 0
    for outer in range(1, max_outer + 1):
        # ---- inner: projected GN-CG on the AL to tolerance omega ----
        for _ in range(max_inner):
            inner_total += 1
            dpsi = 1.0 + 3.0 * alpha * x * x
            r = J0 @ (x + alpha * x**3) - y
            e = A @ x - b
            g = dpsi * (J0.T @ r) + A.T @ (nu + mu * e)
            # Projected-gradient criticality of the AL subproblem.
            pg = x - np.clip(x - g, xl, xu)
            if np.linalg.norm(pg) <= max(omega, crit_tol):
                break
            on_lo = (x - xl <= 1e-12 * (1 + np.abs(x))) & (g > 0)
            on_hi = (xu - x <= 1e-12 * (1 + np.abs(x))) & (g < 0)
            free = ~(on_lo | on_hi)

            def hv(v):
                vf = np.where(free, v, 0.0)
                out = dpsi * (J0.T @ (J0 @ (dpsi * vf))) + mu * (A.T @ (A @ vf))
                return np.where(free, out, 0.0)

            # CG on the free coords, truncated (Steihaug-style on bound
            # hits is handled by the projected linesearch instead).
            rhs = np.where(free, -g, 0.0)
            v = np.zeros_like(x)
            rr = rhs.copy()
            p = rr.copy()
            rs = rr @ rr
            tol2 = (0.1 * np.sqrt(rs)) ** 2
            for _cg in range(max_cg):
                cg_total += 1
                hp = hv(p)
                php = p @ hp
                if php <= 1e-300:
                    break
                a_step = rs / php
                v += a_step * p
                rr -= a_step * hp
                rs_new = rr @ rr
                if rs_new <= tol2:
                    break
                p = rr + (rs_new / rs) * p
                rs = rs_new
            if np.linalg.norm(v) <= 1e-300:
                v = rhs  # fall back to projected gradient
            # Projected backtracking linesearch on the AL merit.
            m0 = merit(x)
            t = 1.0
            for _ls in range(30):
                xt = np.clip(x + t * v, xl, xu)
                if merit(xt) <= m0 - 1e-4 * t * abs(g @ v):
                    break
                t *= 0.5
            x = np.clip(x + t * v, xl, xu)

        # ---- outer: multiplier / penalty update ----
        e = A @ x - b
        feas = np.linalg.norm(e)
        r = J0 @ (x + alpha * x**3) - y
        dpsi = 1.0 + 3.0 * alpha * x * x
        gL = dpsi * (J0.T @ r) + A.T @ nu
        pix = np.linalg.norm(project_polyhedron_np(x - gL, A, b, xl, xu) - x)
        if pix <= crit_tol and feas <= feas_tol:
            break
        if feas <= max(eta, feas_tol):
            nu = nu + mu * e
            omega, eta = omega / mu, eta / mu**0.9
        else:
            mu *= tau
            omega, eta = 1.0 / mu, 1.0 / mu**0.1
        omega = max(omega, crit_tol)
        eta = max(eta, feas_tol)

    return x, {
        "converged": bool(pix <= crit_tol and feas <= feas_tol),
        "pix": float(pix), "feas": float(feas),
        "outer": outer, "inner": inner_total, "cg": cg_total,
    }
