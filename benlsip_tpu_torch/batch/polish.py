"""Warm-start SQP polish and certification (PyTorch port of the range-space
QR route of `benlsip_tpu/batch/polish.py`).

At the f32 bulk solution the active set is identified and the point lies
within ~sqrt(eps(f32)) of the optimum, so a few fixed-active-set
Gauss-Newton SQP steps reach the f64 KKT region.  Each step solves

    [ RJᵀRJ   (EZ)ᵀ ] [dx]   [rhs_x]       RJ = qr_r([JZ; D_fixed])
    [  EZ       0   ] [dν] = [rhs_e]       Wᵀ = RJ⁻ᵀ(EZ)ᵀ = Qw Tw

through its range-space QR factors (see the JAX module for the algebra).
The factor phase runs in float32 — `qr_r` at (B, d+n, n) and `thin_qr` at
(B, n, p+m), the QR kernel's shapes — and the chord phase iterates
f64 residuals against the frozen f32 factors (mixed-precision iterative
refinement).  Every lane is then certified with exact-projection
criticality ‖P_Ω(x − ∇L) − x‖ and ‖c‖; uncertified lanes get re-polish
rounds and then the full f64 refine (`fallback_full_refine`).

Not ported yet: the assembled-KKT LU route (`_factor_phase`,
`_chord_phase`, `sqp_polish`, `sqp_polish_split`) and with it the
all-f64 host certification.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._batched import full, mtv, mv, norm, tree_map, vdot
from ..ops.constraints import Polyhedron
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from ..solver.status import SOLVE_CONVERGED, SOLVE_MAX_OUTER
from .vmap_solve import BatchedProblem, map_poly_fields

Tensor = torch.Tensor


def _trisolve(R: Tensor, b: Tensor, upper: bool) -> Tensor:
    """Batched triangular solve with a vector right-hand side (B, k)."""
    return torch.linalg.solve_triangular(R, b.unsqueeze(-1), upper=upper).squeeze(-1)


def _kkt_solve_qr(RJ: Tensor, Qw: Tensor, Tw: Tensor, rhs_x: Tensor, rhs_e: Tensor):
    """Solve the GN KKT system through its range-space QR factors:
    z₀ = RJ⁻ᵀ rhs_x, TwᵀTw dν = W z₀ − rhs_e, dx = RJ⁻¹(z₀ − Wᵀdν)."""
    z0 = _trisolve(RJ.mT, rhs_x, upper=False)
    if Tw.shape[-1] == 0:
        return _trisolve(RJ, z0, upper=True), torch.zeros_like(rhs_e)
    u = mtv(Qw, z0) - _trisolve(Tw.mT, rhs_e, upper=False)
    dnu = _trisolve(Tw, u, upper=True)
    t = z0 - mv(Qw, mv(Tw, dnu))
    return _trisolve(RJ, t, upper=True), dnu


def _factor_phase_qr(fns, poly: Polyhedron, x0: Tensor, refactor_steps: int,
                     active_tol: float, reg: float):
    """Active-set settling + range-space QR factorization steps.

    Bounds within active_tol (relative) of the warm start are candidates;
    which are fixed is re-decided every step from the sign of the current
    Lagrangian gradient (the first step fixes every candidate).  Returns
    (x, nu, RJ, Qw, Tw, free).
    """
    from ..ops.qr import qr_r, thin_qr

    dtype = x0.dtype
    B, n = x0.shape
    A, b = poly.A, poly.b
    m = A.shape[-2]
    p = fns.nlconstraints(x0).shape[-1]

    scale = 1.0 + torch.abs(x0)
    at_lo = torch.isfinite(poly.xl) & ((x0 - poly.xl) <= active_tol * scale)
    at_hi = torch.isfinite(poly.xu) & ((poly.xu - x0) <= active_tol * scale)
    x = torch.where(at_lo, poly.xl, torch.where(at_hi, poly.xu, x0))
    nu = torch.zeros((B, p + m), dtype=dtype, device=x0.device)
    RJ = Qw = Tw = free = None
    sreg = torch.sqrt(torch.tensor(reg, dtype=dtype, device=x0.device))
    for k in range(max(refactor_steps, 1)):
        r = fns.residuals(x)
        J = fns.jac_res(x)
        e = torch.cat([fns.nlconstraints(x), mv(A, x) - b], dim=-1)      # (B, p+m)
        E = torch.cat([fns.jac_nlcons(x), A], dim=-2)                    # (B, p+m, n)
        gL = mtv(J, r) + mtv(E, nu)
        keep_lo = at_lo & (gL >= 0)
        keep_hi = at_hi & (gL <= 0)
        fixed = (at_lo | at_hi) if k == 0 else (keep_lo | keep_hi)
        free = (~fixed).to(dtype)

        EZ = E * free.unsqueeze(-2)
        JZ = J * free.unsqueeze(-2)
        dbot = torch.where(fixed, torch.ones((), dtype=dtype, device=x0.device), sreg)
        RJ = qr_r(torch.cat([JZ, torch.diag_embed(dbot)], dim=-2))       # (B, n, n)
        Wt = torch.linalg.solve_triangular(RJ.mT, EZ.mT, upper=False)   # (B, n, p+m)
        Qw, Tw = thin_qr(Wt)
        rhs = -(free * mtv(J, r))
        dx, dnu = _kkt_solve_qr(RJ, Qw, Tw, rhs, -e)
        x = torch.clamp(x + dx * free, poly.xl, poly.xu)
        nu = dnu
    return x, nu, RJ, Qw, Tw, free


def _certify(fns, poly: Polyhedron, x: Tensor, nu: Tensor, p: int, crit_tol: float, feas_tol: float):
    """Exact-projection criticality (dual warm-started with the A-block
    multipliers) + feasibility.  Returns (x, y, converged, pix, feas, objective)."""
    from ..ops.polyproject import projection_polyhedron

    A, b = poly.A, poly.b
    y = nu[:, :p]
    r = fns.residuals(x)
    c = fns.nlconstraints(x)
    gL = mtv(fns.jac_res(x), r) + mtv(fns.jac_nlcons(x), y)
    pix = norm(projection_polyhedron(poly, x - gL, lam0=nu[:, p:]) - x)
    feas = torch.sqrt((c * c).sum(-1) + ((mv(A, x) - b) ** 2).sum(-1))
    converged = (pix <= crit_tol) & (feas <= feas_tol)
    return x, y, converged, pix, feas, 0.5 * vdot(r, r)


def _chord_phase_qr(fns, poly: Polyhedron, x: Tensor, nu: Tensor, RJ: Tensor, Qw: Tensor,
                    Tw: Tensor, free: Tensor, chord_steps: int, crit_tol: float, feas_tol: float):
    """Frozen-factor (chord) Newton steps in delta form + certification.

    The right-hand side is the exact KKT residual in the working dtype;
    the solve runs in the factors' dtype (float32 factors with float64
    state: mixed-precision iterative refinement)."""
    A, b = poly.A, poly.b
    p = nu.shape[-1] - A.shape[-2]
    fdt = RJ.dtype
    for _ in range(chord_steps):
        r = fns.residuals(x)
        J = fns.jac_res(x)
        e = torch.cat([fns.nlconstraints(x), mv(A, x) - b], dim=-1)
        gL = mtv(J, r) + mtv(torch.cat([fns.jac_nlcons(x), A], dim=-2), nu)
        dx, dnu = _kkt_solve_qr(RJ, Qw, Tw, (-(free * gL)).to(fdt), (-e).to(fdt))
        x = torch.clamp(x + dx.to(x.dtype) * free, poly.xl, poly.xu)
        nu = nu + dnu.to(nu.dtype)
    return _certify(fns, poly, x, nu, p, crit_tol, feas_tol)


def _polish_round(bp32, theta32, bp64, theta64, X64: Tensor, rs: int, num_steps: int,
                  active_tol: float, reg: float, crit_tol: float, feas_tol: float):
    """One polish pass over a (sub-)batch: f32 QR factor phase, f64 chord
    phase and certification."""
    B, n = X64.shape
    dev = X64.device
    poly32 = bp32.polyhedron(n, torch.float32, B, dev)
    poly64 = bp64.polyhedron(n, torch.float64, B, dev)
    fns32 = bp32.instance_fns(theta32)
    fns64 = bp64.instance_fns(theta64)
    x, nu, RJ, Qw, Tw, free = _factor_phase_qr(
        fns32, poly32, X64.to(torch.float32), rs, active_tol, reg
    )
    # Snap fixed coordinates from the f32-rounded image of their bound to
    # the f64 bound, so the certificate sees no ~eps(f32) face offset.
    x64 = x.to(torch.float64)
    fixedm = free == 0
    lo_near = torch.abs(x64 - poly64.xl) <= torch.abs(poly64.xu - x64)
    x64 = torch.where(fixedm & torch.isfinite(poly64.xl) & lo_near, poly64.xl, x64)
    x64 = torch.where(fixedm & torch.isfinite(poly64.xu) & ~lo_near, poly64.xu, x64)
    return _chord_phase_qr(
        fns64, poly64, x64, nu.to(torch.float64), RJ, Qw, Tw, free.to(torch.float64),
        num_steps - rs, crit_tol, feas_tol,
    )


def _take_batched(bp: BatchedProblem, theta, idx: Tensor):
    """Gather instance subset idx from theta and any per-instance
    polyhedron fields."""
    take = lambda a: a[idx]
    return map_poly_fields(bp, take), tree_map(take, theta)


def sqp_polish_fused(
    bp32: BatchedProblem,
    theta32,
    X32: Tensor,
    bp64: BatchedProblem,
    theta64,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 5,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    refactor_steps: int = 2,
    rounds: int = 2,
    straggler_bucket: int = 64,
):
    """Device-resident split polish: f32 QR factors + f64 chord +
    certification, then bucketed re-polish passes for uncertified lanes.

    (The name is the JAX one; eager PyTorch runs it as several launches.)
    Each uncertified lane gets up to `rounds - 1` re-polishes, served
    least-attempted first in buckets of at most `straggler_bucket` lanes;
    unlike the JAX version there is no cap on the number of passes, so no
    straggler is left without its re-polish.  All inputs live on X32's
    device.  Returns (X, Y, converged, pix, feas, objective) in f64.
    """
    opts = options.resolve_tols(torch.float64)
    rs = min(max(refactor_steps, 1), num_steps)
    args = (rs, num_steps, active_tol, reg, float(opts.crit_tol), float(opts.feas_tol))

    x, y, ok, pix, feas, obj = _polish_round(
        bp32, theta32, bp64, theta64, X32.to(torch.float64), *args
    )
    att = torch.zeros_like(ok, dtype=torch.int32)
    K = max(straggler_bucket, 1)
    while True:
        eligible = (~ok) & (att < rounds - 1)
        n_elig = int(eligible.sum())
        if n_elig == 0:
            break
        score = torch.where(eligible, (rounds - att).to(torch.float32), 0.0)
        idx = torch.sort(score, descending=True, stable=True).indices[: min(K, n_elig)]
        bp32_k, th32_k = _take_batched(bp32, theta32, idx)
        bp64_k, th64_k = _take_batched(bp64, theta64, idx)
        nx, ny, nok, npix, nfeas, nobj = _polish_round(bp32_k, th32_k, bp64_k, th64_k, x[idx], *args)
        x[idx], y[idx], ok[idx] = nx, ny, nok
        pix[idx], feas[idx], obj[idx] = npix, nfeas, nobj
        att[idx] += 1
    return x, y, ok, pix, feas, obj


def _gather_uncertified(ok: Tensor) -> Tensor:
    """Indices of the uncertified lanes.  (The JAX version pads them to a
    power-of-two bucket to bound compiled shapes; eager PyTorch compiles
    nothing.)"""
    return torch.nonzero(~ok).squeeze(-1)


def polish_then_refine(
    bp: BatchedProblem,
    theta,
    X32: Tensor,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 3,
    active_tol: float = 1e-4,
    chunk: int = 512,
    rounds: int = 2,
    refactor_steps: int = 2,
    bp32: Optional[BatchedProblem] = None,
    theta32=None,
    straggler_bucket: int = 64,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """f64 certification phase on X32's device: fused SQP polish (f32 QR
    factors, f64 chord steps, exact-projection certificate, re-polish
    rounds) + full-refine fallback for the lanes still uncertified.

    `bp32`/`theta32` are the bulk phase's float32 working set on the same
    device.  Returns f64 (X, Y, SolveInfo).
    """
    if bp32 is None or theta32 is None:
        raise NotImplementedError(
            "the all-f64 polish (sqp_polish, the host certification route) is not ported yet; "
            "pass the bulk phase's float32 working set as bp32/theta32"
        )
    from .refine import _cast_problem, _cast_tree

    dev = X32.device
    theta64 = _cast_tree(tree_map(lambda a: a.to(dev), theta), torch.float64)
    bp64 = _cast_problem(bp, torch.float64, dev)
    X, Y, ok, pix, feas, obj = sqp_polish_fused(
        bp32, theta32, X32, bp64, theta64, options,
        num_steps=num_steps, active_tol=active_tol,
        refactor_steps=refactor_steps, rounds=rounds,
        straggler_bucket=straggler_bucket,
    )
    B = X.shape[0]
    opts = options.resolve_tols(torch.float64)
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    info = SolveInfo(
        converged=ok,
        status=torch.where(ok, SOLVE_CONVERGED, SOLVE_MAX_OUTER).to(torch.int32),
        outer_iters=zeros_i,
        inner_iters=torch.full_like(zeros_i, num_steps),
        pix=pix,
        feas=feas,
        mu=full(B, opts.mu0, X),
        objective=obj,
        minor_iters=zeros_i.clone(),
        cg_iters=zeros_i.clone(),
    )
    if bool(ok.all()):
        return X, Y, info
    return fallback_full_refine(bp64, theta64, X, Y, info, options, chunk)


def fallback_full_refine(bp64, theta64, X: Tensor, Y: Tensor, info: SolveInfo, options, chunk: int):
    """Full-f64-refine fallback for the uncertified lanes (`info.converged`)
    on their own device, warm-started from the polished points, with the
    stall-restart rescue (one more refine from its own output for the
    lanes the first refine left unconverged); results scattered back."""
    from .refine import refine_f64

    idx = _gather_uncertified(info.converged)
    bp_f, theta_f = _take_batched(bp64, theta64, idx)
    Xf, Yf, inf_f = refine_f64(bp_f, theta_f, X[idx], options, chunk=chunk)
    bad = ~inf_f.converged
    if bool(bad.any()):
        sel2 = _gather_uncertified(~bad)
        bp_r, theta_r = _take_batched(bp_f, theta_f, sel2)
        Xf2, Yf2, inf_f2 = refine_f64(bp_r, theta_r, Xf[sel2], options, chunk=chunk)
        Xf[sel2], Yf[sel2] = Xf2, Yf2
        for f in SolveInfo._fields:
            getattr(inf_f, f)[sel2] = getattr(inf_f2, f)
    X, Y = X.clone(), Y.clone()
    X[idx], Y[idx] = Xf, Yf
    info = SolveInfo(*[getattr(info, f).clone() for f in SolveInfo._fields])
    for f in SolveInfo._fields:
        getattr(info, f)[idx] = getattr(inf_f, f).to(getattr(info, f).dtype)
    return X, Y, info

