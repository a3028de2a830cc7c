"""Warm-start SQP polish and certification (PyTorch port of
`benlsip_tpu/batch/polish.py`).

At the f32 bulk solution the active set is identified and the point lies
within ~sqrt(eps(f32)) of the optimum, so a few fixed-active-set
Gauss-Newton SQP steps reach the f64 KKT region.  Each step solves the
KKT system of  min ½‖J dx + r‖²  s.t.  E dx = -e,  dx_i = 0 (i fixed),
E = [C; A], through one of two factorizations (`sqp_polish`'s
`kkt_factorization`; "auto" picks by the factors' dtype):

* "qr", range-space: RJ = qr_r([JZ; D_fixed]) and Wᵀ = RJ⁻ᵀ(EZ)ᵀ = Qw Tw
  (`qr_r_stacked` at (B, d+n, n): one launch of the narrow QR kernel's
  R-only form at n ≤ 16, which makes D's rows up, the panel QR kernel on
  the stacked matrix above; `thin_qr` at (B, n, p+m): the narrow kernel),
  O(κ(J)·eps) — the route for float32 factors;
* "lu": the assembled (n+p+m)² KKT matrix
  [[ZJᵀJZ + diag(fixed) + reg·Z, (EZ)ᵀ], [EZ, -dual_reg·I]] by LU,
  O(κ(J)²·eps) — the float64 default.

`refactor_steps` factor-phase steps (the active set re-decided every step
from the sign of the Lagrangian gradient) are followed by chord steps on
the frozen factors in delta form: the right-hand side is the exact KKT
residual in the working dtype and the solve runs in the factors' dtype, so
f32 factors with f64 state are mixed-precision iterative refinement.
Every lane is then certified with exact-projection criticality
‖P_Ω(x − ∇L) − x‖ and ‖c‖; uncertified lanes get re-polish rounds and
then the full f64 refine (`fallback_full_refine`).

With nonlinear constraints (p > 0) the H block is the Lagrangian's whole
Hessian, JᵀJ + W with W = Σⱼ rⱼ∇²rⱼ + Σᵢ yᵢ∇²cᵢ
(`NLSFunctions.lagrangian_curvature`), at the bulk's multipliers on the
first factor step when the pipeline hands them over and at the step's
own ν after it: without W the chord's operator misses a term as large as
JᵀJ wherever y is of order one (2y·I for a sphere), or wherever the
residuals' curvature is (`sphere_family`), and the chord contracts
slowly or not at all.  The LU route adds W to H; the QR route factors
H + W by Cholesky (`_with_curvature`), shifted by σ(EZ)ᵀ(EZ) on a lane
where H + W is indefinite.  p = 0 runs the same operations as before,
Gauss-Newton.  (A deliberate difference: the JAX package's polish is
Gauss-Newton for every p.)

Three pipelines share these pieces (`polish_then_refine` routes them):
`sqp_polish_fused` (f32 QR factors and f64 chord on the device the bulk
ran on), `sqp_polish_split` (f32 factors there, f64 chord on the CPU) and
`sqp_polish` (everything in one dtype on one device).  Every one of them
runs at least one chord step: `refactor_steps` is clamped to
`num_steps - 1` (the JAX package can run zero and then certifies the f32
factor point).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _trace
from .._batched import full, mtv, mv, norm, sel, tree_map, vdot
from .._loops import branch_any, host_any, host_count, masked_while
from ..ops.constraints import Polyhedron
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from ..solver.status import SOLVE_CONVERGED, SOLVE_MAX_OUTER
from .vmap_solve import BatchedProblem, map_poly_fields

Tensor = torch.Tensor
_CPU = torch.device("cpu")


def _split_steps(num_steps: int, refactor_steps: int) -> Tuple[int, int]:
    """(factor-phase steps, chord steps) of a `num_steps` budget: at least
    one of each."""
    if num_steps < 2:
        raise ValueError(f"num_steps={num_steps}: a polish needs a factor step and a chord step")
    rs = min(max(refactor_steps, 1), num_steps - 1)
    return rs, num_steps - rs


def _resolve_kkt(kkt_factorization: str, dtype: torch.dtype) -> str:
    """"auto": "qr" for float32 factors (no κ² headroom), "lu" for float64."""
    if kkt_factorization not in ("auto", "lu", "qr"):
        raise ValueError(f"kkt_factorization={kkt_factorization!r}: expected 'auto', 'lu' or 'qr'")
    if kkt_factorization != "auto":
        return kkt_factorization
    return "qr" if dtype in (torch.float32, torch.bfloat16) else "lu"


def _trisolve(R: Tensor, b: Tensor, upper: bool) -> Tensor:
    """Batched triangular solve with a vector right-hand side (B, k)."""
    return torch.linalg.solve_triangular(R, b.unsqueeze(-1), upper=upper).squeeze(-1)


def _cast_factors(F, device, dtype):
    """Factors moved to device, their floating-point fields cast to dtype."""
    return type(F)(*[a.to(device=device, dtype=dtype if a.is_floating_point() else a.dtype) for a in F])


class _QRFactors(NamedTuple):
    """Range-space factors RJ (B, n, n), Qw (B, n, q), Tw (B, q, q)."""

    RJ: Tensor
    Qw: Tensor
    Tw: Tensor

    def solve(self, rhs_x: Tensor, rhs_e: Tensor):
        """z₀ = RJ⁻ᵀ rhs_x, TwᵀTw dν = W z₀ − rhs_e, dx = RJ⁻¹(z₀ − Wᵀdν)."""
        RJ, Qw, Tw = self
        z0 = _trisolve(RJ.mT, rhs_x, upper=False)
        if Tw.shape[-1] == 0:
            return _trisolve(RJ, z0, upper=True), torch.zeros_like(rhs_e)
        u = mtv(Qw, z0) - _trisolve(Tw.mT, rhs_e, upper=False)
        dnu = _trisolve(Tw, u, upper=True)
        t = z0 - mv(Qw, mv(Tw, dnu))
        return _trisolve(RJ, t, upper=True), dnu


class _ShiftedQRFactors(NamedTuple):
    """Range-space factors of H + W + σ(EZ)ᵀ(EZ) (`_with_curvature`): RJ,
    Qw and Tw as `_QRFactors`, and S = σ·EZ (B, q, n), zero on a lane
    without the shift.  Since E dx = rhs_e, the shifted system with
    rhs_x + σ(EZ)ᵀrhs_e has the unshifted system's solution."""

    RJ: Tensor
    Qw: Tensor
    Tw: Tensor
    S: Tensor

    def solve(self, rhs_x: Tensor, rhs_e: Tensor):
        return _QRFactors(*self[:3]).solve(rhs_x + mtv(self.S, rhs_e), rhs_e)


class _LUFactors(NamedTuple):
    """LU factors of the assembled KKT matrix, (B, n+q, n+q), and pivots."""

    LU: Tensor
    piv: Tensor

    def solve(self, rhs_x: Tensor, rhs_e: Tensor):
        rhs = torch.cat([rhs_x, rhs_e], dim=-1).unsqueeze(-1)
        sol = torch.linalg.lu_solve(self.LU, self.piv, rhs).squeeze(-1)
        n = rhs_x.shape[-1]
        return sol[:, :n], sol[:, n:]


# The shift that `_with_curvature` adds where H + W is not positive
# definite: σ·(EZ)ᵀ(EZ) with σ = CURVATURE_SHIFT·‖H + W‖_F / ‖EZ‖_F².
CURVATURE_SHIFT = 1.0


def _with_curvature(RJ: Tensor, EZ: Tensor, WZ: Tensor):
    """(R, S): R the upper Cholesky factor of RJᵀRJ + WZ (H + W on the free
    coordinates) on each lane where that sum is positive definite; else of
    the sum plus σ(EZ)ᵀ(EZ), which is positive definite for σ large enough
    wherever H + W is on E's null space, with S = σ·EZ; else RJ itself,
    the Gauss-Newton factor.  The shifted factorization runs only when a
    lane needs it (`_loops.branch_any`: an IF node under capture)."""
    G = RJ.mT @ RJ + WZ
    R0, info = torch.linalg.cholesky_ex(G, upper=True)
    ok = info == 0

    def shifted():
        sigma = CURVATURE_SHIFT * torch.linalg.matrix_norm(G) / torch.linalg.matrix_norm(EZ).square()
        S = sigma[:, None, None] * EZ
        R1, info1 = torch.linalg.cholesky_ex(G + EZ.mT @ S, upper=True)
        take = ~ok & (info1 == 0)
        return sel(take, R1, R0), sel(take, S, torch.zeros_like(S)), ok | take

    R, S, ok = branch_any(~ok, shifted, (R0, torch.zeros_like(EZ), ok))
    return sel(ok, R, RJ), S


def _factor_qr(JZ: Tensor, EZ: Tensor, fixed: Tensor, reg: float, dual_reg: float,
               WZ: Optional[Tensor] = None):
    """RJ = qr_r([JZ; D]) with D = diag(fixed ? 1 : sqrt(reg)), so RJᵀRJ is
    the KKT matrix's H block, and Qw Tw = RJ⁻ᵀ(EZ)ᵀ (`dual_reg` is the LU
    route's; the range-space solve needs none).  With the curvature
    WZ = ZWZ the H block is H + W, factored by `_with_curvature`
    (`_ShiftedQRFactors`)."""
    from ..ops.qr import qr_r_stacked, thin_qr

    sreg = torch.sqrt(torch.full((), reg, dtype=JZ.dtype, device=JZ.device))
    dbot = torch.where(fixed, torch.ones((), dtype=JZ.dtype, device=JZ.device), sreg)
    RJ = qr_r_stacked(JZ, dbot)                                       # (B, n, n)
    S = None
    if WZ is not None:
        RJ, S = _with_curvature(RJ, EZ, WZ)
    Wt = torch.linalg.solve_triangular(RJ.mT, EZ.mT, upper=False)    # (B, n, q)
    return _QRFactors(RJ, *thin_qr(Wt)) if S is None else _ShiftedQRFactors(RJ, *thin_qr(Wt), S)


def _factor_lu(JZ: Tensor, EZ: Tensor, fixed: Tensor, reg: float, dual_reg: float,
               WZ: Optional[Tensor] = None) -> _LUFactors:
    """LU of [[JZᵀJZ + WZ + diag(fixed) + reg·Z, (EZ)ᵀ], [EZ, -dual_reg·I]]
    (WZ = ZWZ, the constraints' curvature, when given)."""
    dtype = JZ.dtype
    q = EZ.shape[-2]
    fx = fixed.to(dtype)
    H = JZ.mT @ JZ + torch.diag_embed(fx + reg * (1.0 - fx))
    if WZ is not None:
        H = H + WZ
    dual = (-dual_reg * torch.eye(q, dtype=dtype, device=JZ.device)).expand(EZ.shape[0], q, q)
    K = torch.cat([torch.cat([H, EZ.mT], dim=-1), torch.cat([EZ, dual], dim=-1)], dim=-2)
    # No error check: a singular lane gives non-finite steps and fails its
    # certificate, as LAPACK's getrf does in the JAX package.
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    return _LUFactors(LU, piv)


_FACTOR = {"qr": _factor_qr, "lu": _factor_lu}


def _curvature(fns, x: Tensor, y: Optional[Tensor], free: Tensor) -> Optional[Tensor]:
    """ZWZ with W = Σⱼ rⱼ∇²rⱼ(x) + Σᵢ yᵢ∇²cᵢ(x), or None where there is no
    such term (p = 0, no multipliers yet, or no `lagrangian_curvature`)."""
    if y is None or y.shape[-1] == 0 or fns.lagrangian_curvature is None:
        return None
    return fns.lagrangian_curvature(x, y) * free.unsqueeze(-1) * free.unsqueeze(-2)


def _factor_phase(fns, poly: Polyhedron, x0: Tensor, refactor_steps: int, active_tol: float,
                  kkt: str, reg: float, dual_reg: float = 1e-14, y0: Optional[Tensor] = None):
    """Active-set settling + KKT factorization steps.

    Bounds within active_tol (relative) of the warm start are candidates;
    which are fixed is re-decided every step from the sign of the current
    Lagrangian gradient (the first step fixes every candidate).  With
    p > 0 the curvature W enters H at the multipliers y0 (B, p) on the
    first step (none when y0 is None) and at the previous step's ν after
    it, and a bound that a step was clamped to becomes a candidate too: a
    Newton step of H + W from the loose bulk can overshoot a bound that
    belongs to the active set, and a free coordinate clamped back on every
    step leaves the equalities violated by the overshoot.  (p = 0 keeps
    the warm start's candidates, the JAX package's rule.)
    Returns (x, nu, factors, free).
    """
    dtype = x0.dtype
    B, n = x0.shape
    A, b = poly.A, poly.b
    m = A.shape[-2]
    p = fns.nlconstraints(x0).shape[-1]
    factor = _FACTOR[kkt]

    scale = 1.0 + torch.abs(x0)
    at_lo = torch.isfinite(poly.xl) & ((x0 - poly.xl) <= active_tol * scale)
    at_hi = torch.isfinite(poly.xu) & ((poly.xu - x0) <= active_tol * scale)
    x = torch.where(at_lo, poly.xl, torch.where(at_hi, poly.xu, x0))
    nu = torch.zeros((B, p + m), dtype=dtype, device=x0.device)
    y = None if y0 is None else y0.to(dtype)
    F = free = None
    for k in range(max(refactor_steps, 1)):
        r = fns.residuals(x)
        J = fns.jac_res(x)
        e = torch.cat([fns.nlconstraints(x), mv(A, x) - b], dim=-1)      # (B, p+m)
        E = torch.cat([fns.jac_nlcons(x), A], dim=-2)                    # (B, p+m, n)
        gL = mtv(J, r) + mtv(E, nu)
        if k > 0 and p > 0:
            y = nu[:, :p]
            at_lo = at_lo | (x <= poly.xl)
            at_hi = at_hi | (x >= poly.xu)
        keep_lo = at_lo & (gL >= 0)
        keep_hi = at_hi & (gL <= 0)
        fixed = (at_lo | at_hi) if k == 0 else (keep_lo | keep_hi)
        free = (~fixed).to(dtype)

        F = factor(J * free.unsqueeze(-2), E * free.unsqueeze(-2), fixed, reg, dual_reg,
                   _curvature(fns, x, y, free))
        dx, dnu = F.solve(-(free * mtv(J, r)), -e)
        x = torch.clamp(x + dx * free, poly.xl, poly.xu)
        nu = dnu
    return x, nu, F, free


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


def _chord_phase(fns, poly: Polyhedron, x: Tensor, nu: Tensor, F, free: Tensor,
                 chord_steps: int, crit_tol: float, feas_tol: float):
    """Frozen-factor (chord) Newton steps in delta form + certification.

    The right-hand side is the exact KKT residual in the working dtype;
    the solve runs in the factors' dtype (float32 factors with float64
    state: mixed-precision iterative refinement)."""
    A, b = poly.A, poly.b
    p = nu.shape[-1] - A.shape[-2]
    fdt = F[0].dtype
    for _ in range(chord_steps):
        r = fns.residuals(x)
        J = fns.jac_res(x)
        e = torch.cat([fns.nlconstraints(x), mv(A, x) - b], dim=-1)
        gL = mtv(J, r) + mtv(torch.cat([fns.jac_nlcons(x), A], dim=-2), nu)
        dx, dnu = F.solve((-(free * gL)).to(fdt), (-e).to(fdt))
        x = torch.clamp(x + dx.to(x.dtype) * free, poly.xl, poly.xu)
        nu = nu + dnu.to(nu.dtype)
    return _certify(fns, poly, x, nu, p, crit_tol, feas_tol)


def _snap_fixed(x64: Tensor, free: Tensor, poly64: Polyhedron) -> Tensor:
    """Fixed coordinates arrive on the f32-rounded image of their bound:
    snap them to the f64 bound, so the certificate sees no ~eps(f32) face
    offset."""
    fixedm = free == 0
    lo_near = torch.abs(x64 - poly64.xl) <= torch.abs(poly64.xu - x64)
    x64 = torch.where(fixedm & torch.isfinite(poly64.xl) & lo_near, poly64.xl, x64)
    return torch.where(fixedm & torch.isfinite(poly64.xu) & ~lo_near, poly64.xu, x64)


def _f32_factor_then_f64_chord(bp32, theta32, X32: Tensor, bp64, theta64, dev, rs: int, chord: int,
                               kkt: str, active_tol: float, reg: float, dual_reg: float,
                               crit_tol: float, feas_tol: float, promote: bool, Y32: Optional[Tensor] = None):
    """The factor phase in float32 on X32's device, then the chord phase and
    certificate in float64 on `dev`, where bp64/theta64 live (the CPU for
    the split polish, X32's own device for the fused one).  `promote`
    casts the factors to float64 (the split polish); otherwise they stay
    float32.  Y32: the multipliers of the first factor step's curvature
    (`_factor_phase`'s y0)."""
    B, n = X32.shape
    poly32 = bp32.polyhedron(n, torch.float32, B, X32.device)
    x, nu, F, free = _factor_phase(
        bp32.instance_fns(theta32), poly32, X32.to(torch.float32), rs, active_tol, kkt, reg, dual_reg,
        None if Y32 is None else Y32.to(device=X32.device, dtype=torch.float32),
    )
    poly64 = bp64.polyhedron(n, torch.float64, B, dev)
    f64 = lambda t: t.to(device=dev, dtype=torch.float64)
    F = _cast_factors(F, dev, torch.float64 if promote else torch.float32)
    return _chord_phase(
        bp64.instance_fns(theta64), poly64, _snap_fixed(f64(x), f64(free), poly64), f64(nu), F,
        f64(free), chord, crit_tol, feas_tol,
    )


def sqp_polish(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 3,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    dual_reg: float = 1e-14,
    refactor_steps: int = 2,
    kkt_factorization: str = "auto",
    Y0: Optional[Tensor] = None,
):
    """Fixed-active-set SQP polish of warm starts X0 (B, n), factors and
    chord in X0's dtype on X0's device (bp/theta already there).  Y0: the
    warm starts' multipliers (B, p), for the first factor step's
    constraint curvature (`_factor_phase`).

    Returns (X, Y, converged, pix, feas, objective); `converged` is the
    per-lane certification mask.
    """
    rs, chord = _split_steps(num_steps, refactor_steps)
    B, n = X0.shape
    opts = options.resolve_tols(X0.dtype)
    poly = bp.polyhedron(n, X0.dtype, B, X0.device)
    fns = bp.instance_fns(theta)
    kkt = _resolve_kkt(kkt_factorization, X0.dtype)
    x, nu, F, free = _factor_phase(fns, poly, X0, rs, active_tol, kkt, reg, dual_reg, Y0)
    return _chord_phase(fns, poly, x, nu, F, free, chord, float(opts.crit_tol), float(opts.feas_tol))


def sqp_polish_split(
    bp32: BatchedProblem,
    theta32,
    X32: Tensor,
    bp64: BatchedProblem,
    theta64,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 5,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    dual_reg: float = 1e-14,
    refactor_steps: int = 2,
    kkt_factorization: str = "auto",
    Y32: Optional[Tensor] = None,
):
    """Device-factored polish: the f32 factor phase where X32 lives (the
    card after the bulk), the f64 chord phase and certificate on the CPU
    with the factors promoted to f64 — the JAX package's host
    certification at n ≥ 64.  The O(dn² + n³) factor work stays on the
    device; the CPU pays O(dn + n²) per chord step.  Float32 factors use
    the range-space QR unless `kkt_factorization` says "lu" (`_resolve_kkt`).
    Y32: the bulk's multipliers (`_factor_phase`'s y0).

    bp64/theta64 are the f64 master data (moved to the CPU here).  Returns
    (X, Y, converged, pix, feas, objective) in f64 on the CPU.
    """
    from .refine import _cast_problem, _cast_tree

    rs, chord = _split_steps(num_steps, refactor_steps)
    opts = options.resolve_tols(torch.float64)
    theta_h = _cast_tree(tree_map(lambda a: a.to(_CPU), theta64), torch.float64)
    return _f32_factor_then_f64_chord(
        bp32, theta32, X32, _cast_problem(bp64, torch.float64, _CPU), theta_h, _CPU, rs, chord,
        _resolve_kkt(kkt_factorization, X32.dtype), active_tol, reg, dual_reg,
        float(opts.crit_tol), float(opts.feas_tol), promote=True, Y32=Y32,
    )


def _take_batched(bp: BatchedProblem, theta, idx: Tensor):
    """Gather instance subset idx from theta and any per-instance
    polyhedron fields."""
    take = lambda a: a[idx]
    return map_poly_fields(bp, take), tree_map(take, theta)


class PolishState(NamedTuple):
    """The fused certification's per-lane state: the polished point and
    its certificate, and the re-polishes each lane has had."""

    x: Tensor
    y: Tensor
    ok: Tensor
    pix: Tensor
    feas: Tensor
    obj: Tensor
    att: Tensor


class FusedPolish:
    """The fused certification of one batch: `first_round` (f32 QR
    factors, f64 chord, certificate), then passes over buckets of at most
    `straggler_bucket` uncertified lanes, served least-attempted first,
    polished again and scattered back — `repolish` in the static shapes of
    the JAX program (what `batch/fused_small` captures), or
    `repolish_dynamic` with buckets cut to the lanes owed a pass (the eager
    pipeline's).  Each uncertified lane gets up to `rounds - 1`
    re-polishes."""

    def __init__(self, bp32, theta32, bp64, theta64, options: SolverOptions, num_steps: int,
                 active_tol: float, reg: float, refactor_steps: int, rounds: int, straggler_bucket: int):
        self.rs, self.chord = _split_steps(num_steps, refactor_steps)
        opts = options.resolve_tols(torch.float64)
        self.tols = float(opts.crit_tol), float(opts.feas_tol)
        self.data = bp32, theta32, bp64, theta64
        self.active_tol, self.reg, self.rounds = active_tol, reg, rounds
        self.K = max(straggler_bucket, 1)

    def _round(self, b32, t32, b64, t64, x64: Tensor, y: Optional[Tensor]):
        return _f32_factor_then_f64_chord(
            b32, t32, x64, b64, t64, x64.device, self.rs, self.chord, "qr", self.active_tol, self.reg, 0.0,
            *self.tols, promote=False, Y32=y,
        )

    def first_round(self, X32: Tensor, Y32: Optional[Tensor] = None) -> PolishState:
        """The first polish of every lane; Y32 (B, p), the bulk's
        multipliers, seeds the first factor step's constraint curvature."""
        out = self._round(*self.data, X32.to(torch.float64), Y32)
        return PolishState(*out, att=torch.zeros_like(out[2], dtype=torch.int32))

    def eligible(self, s: PolishState) -> Tensor:
        """The lanes still owed a re-polish."""
        return (~s.ok) & (s.att < self.rounds - 1)

    def _bucket(self, s: PolishState, K: int) -> Tensor:
        """The first K lanes by (attempts, index): eligible least-attempted
        lanes first.  A stable sort, not `topk`, whose order among equal
        scores is unspecified on CUDA."""
        score = torch.where(self.eligible(s), (self.rounds - s.att).to(torch.float32), 0.0)
        return torch.sort(score, descending=True, stable=True).indices[:K]

    def _polish_lanes(self, s: PolishState, idx: Tensor):
        bp32, theta32, bp64, theta64 = self.data
        y = s.y[idx] if s.y.shape[-1] else None    # the lanes' polished ν: their curvature's multipliers
        return self._round(*_take_batched(bp32, theta32, idx), *_take_batched(bp64, theta64, idx), s.x[idx], y)

    def repolish(self, s: PolishState) -> PolishState:
        """The re-polish passes while a lane is owed one (`_loops.masked_while`),
        at most ⌈B / bucket⌉·(rounds − 1) of them: every pass but the last
        serves a full bucket, and each lane is served at most `rounds - 1`
        times."""
        B = s.x.shape[0]
        passes = -(-B // min(self.K, B)) * max(self.rounds - 1, 0)
        return masked_while(self.eligible, self._pass, s, self.eligible(s), passes)

    def _pass(self, s: PolishState, act: Tensor) -> PolishState:
        """One pass in static shapes (the JAX package's `lax.while_loop`
        body): a bucket of min(straggler_bucket, B) lanes, of which only
        the eligible take the new state, certified or not."""
        idx = self._bucket(s, min(self.K, s.x.shape[0]))
        upd = self.eligible(s)[idx]
        new = self._polish_lanes(s, idx)

        def scatter(t: Tensor, t_new: Tensor) -> Tensor:
            out = t.clone()
            out[idx] = sel(upd, t_new, t[idx])
            return out

        return PolishState(*[scatter(t, t_new) for t, t_new in zip(s, new)], att=scatter(s.att, s.att[idx] + 1))

    def repolish_dynamic(self, s: PolishState) -> PolishState:
        """The re-polish passes with a host decision each: a bucket of the
        min(straggler_bucket, eligible) lanes served first, written back in
        place, until no lane is owed a pass (no cap on the passes)."""
        while (n_elig := host_count(self.eligible(s))) > 0:
            idx = self._bucket(s, min(self.K, n_elig))
            for t, t_new in zip(s, self._polish_lanes(s, idx)):
                t[idx] = t_new
            s.att[idx] += 1
        return s


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
    Y32: Optional[Tensor] = None,
):
    """Device-resident split polish: f32 QR factors + f64 chord +
    certification, then bucketed re-polish passes for uncertified lanes.

    (The name is the JAX one; eager PyTorch runs it as several launches,
    `FusedPolish.repolish_dynamic`.)  Each uncertified lane gets up to
    `rounds - 1` re-polishes, served least-attempted first in buckets of at
    most `straggler_bucket` lanes; unlike the JAX version there is no cap
    on the number of passes, so no straggler is left without its
    re-polish.  All inputs live on X32's device; Y32 are the bulk's
    multipliers (`FusedPolish.first_round`).  Returns (X, Y, converged,
    pix, feas, objective) in f64.
    """
    fp = FusedPolish(bp32, theta32, bp64, theta64, options, num_steps, active_tol, reg,
                     refactor_steps, rounds, straggler_bucket)
    return tuple(fp.repolish_dynamic(fp.first_round(X32, Y32))[:6])


def _gather_uncertified(ok: Tensor) -> Tensor:
    """Indices of the uncertified lanes.  (The JAX version pads them to a
    power-of-two bucket to bound compiled shapes; eager PyTorch compiles
    nothing.)"""
    return torch.nonzero(~ok).squeeze(-1)


def _check_fallback_pad(where: str, fallback_pad: int) -> None:
    """`fallback_pad` is kept at its JAX position and refused at any value
    but 64.  In the JAX package it caps the power-of-two buckets that the
    uncertified lanes are padded to, which bounds XLA's compile cache; the
    padding only repeats lanes, so no result depends on it.  The port pads
    no bucket: a deliberate difference, not a missing feature."""
    if fallback_pad != 64:
        raise ValueError(
            f"{where}(fallback_pad={fallback_pad!r}): fallback_pad is an XLA compile-cache knob of the JAX "
            "package (the padded bucket of uncertified lanes); this port pads no bucket, so only the default "
            "64 is taken. This is a deliberate difference from the JAX package, not a missing feature."
        )


def polish_then_refine(
    bp: BatchedProblem,
    theta,
    X32: Tensor,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 3,
    active_tol: float = 1e-4,
    fallback_pad: int = 64,
    chunk: int = 512,
    device=None,
    rounds: int = 2,
    refactor_steps: int = 2,
    bp32: Optional[BatchedProblem] = None,
    theta32=None,
    split: str = "auto",
    kkt_factorization: str = "auto",
    fallback_device=None,
    straggler_bucket: int = 64,
    Y32: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """f64 certification phase: SQP polish, re-polish rounds and the
    full-refine fallback for the lanes still uncertified.

    `device=None` certifies on X32's device: the fused polish
    (`sqp_polish_fused`: float32 QR factors, f64 chord) when the bulk
    phase's float32 working set `bp32`/`theta32` (on X32's device) is given
    and `split` is not "off", else the all-f64 `sqp_polish` there.
    `device="cpu"` is the host certification: the split polish
    (`sqp_polish_split`: f32 factors where X32 lives, f64 chord on the CPU)
    when `bp32`/`theta32` are given and `split` is "on", or "auto" with
    n ≥ 64; else the all-f64 `sqp_polish` on the CPU.  `split="off"` is
    the opt-out from float32 factors for families whose conditioning needs
    the all-f64 polish.  Outside the fused polish, uncertified lanes get up
    to `rounds - 1` re-polishes through `sqp_polish`.
    `kkt_factorization` goes to every polish but the fused one (QR by
    construction); "auto" is QR for float32 factors and LU for float64 on
    every device (the JAX package takes QR on an accelerator because the
    TPU had no f64 LU).  The lanes still uncertified go to
    `fallback_full_refine` on `fallback_device` (None: where the
    certification ran).  `fallback_pad` is refused at any value but 64
    (`_check_fallback_pad`).  Y32 (B, p), the bulk's multipliers where the
    pipeline has them, seed every polish's first constraint curvature;
    a re-polish starts from its lanes' polished ν.  Returns f64
    (X, Y, SolveInfo) on the certification's device, or on
    `fallback_device` when a lane went to the fallback refine.
    """
    from .refine import _cast_problem, _cast_tree

    _check_fallback_pad("polish_then_refine", fallback_pad)
    if split not in ("auto", "on", "off"):
        raise ValueError(f"split={split!r}: expected 'auto', 'on' or 'off'")
    _resolve_kkt(kkt_factorization, torch.float64)   # refuse an unknown value before any work
    host = device is not None
    if host and torch.device(device).type != "cpu":
        raise ValueError(f"device={device!r}: None (X32's device) or 'cpu' (host certification)")
    dev = _CPU if host else X32.device
    theta64 = _cast_tree(tree_map(lambda a: a.to(dev), theta), torch.float64)
    bp64 = _cast_problem(bp, torch.float64, dev)
    have32 = bp32 is not None and theta32 is not None
    kw = dict(num_steps=num_steps, active_tol=active_tol, refactor_steps=refactor_steps)
    use_fused = have32 and not host and split != "off"
    use_split = have32 and host and (split == "on" or (split == "auto" and X32.shape[-1] >= 64))

    if use_fused:
        X, Y, ok, pix, feas, obj = sqp_polish_fused(
            bp32, theta32, X32, bp64, theta64, options, rounds=rounds,
            straggler_bucket=straggler_bucket, Y32=Y32, **kw,
        )
    else:
        kw["kkt_factorization"] = kkt_factorization
        if use_split:
            out = sqp_polish_split(bp32, theta32, X32, bp64, theta64, options, Y32=Y32, **kw)
        else:
            Y0 = None if Y32 is None else Y32.to(device=dev, dtype=torch.float64)
            out = sqp_polish(bp64, theta64, X32.to(device=dev, dtype=torch.float64), options, Y0=Y0, **kw)
        X, Y, ok, pix, feas, obj = out
        # Re-polish only the uncertified lanes; the re-polished state is
        # taken certified or not, so a further round starts from it.
        for _ in range(rounds - 1):
            if not host_any(~ok):
                break
            idx = _gather_uncertified(ok)
            bp_r, theta_r = _take_batched(bp64, theta64, idx)
            new = sqp_polish(bp_r, theta_r, X[idx], options, Y0=Y[idx] if Y.shape[-1] else None, **kw)
            for t, t_new in zip(out, new):
                t[idx] = t_new
    return finish_polish(bp64, theta64, (X, Y, ok, pix, feas, obj), options, num_steps, chunk, fallback_device)


def finish_polish(bp64, theta64, polished, options: SolverOptions, num_steps: int, chunk: int,
                  fallback_device=None) -> Tuple[Tensor, Tensor, SolveInfo]:
    """The polished lanes' (X, Y, SolveInfo) — converged where certified,
    no outer iterations, `num_steps` inner ones, mu at its start — after
    one host sync to ask whether a lane is uncertified; those go to
    `fallback_full_refine` on `fallback_device`.  Its span is `finish`
    (`_trace`), the sync and the fallback inside it."""
    with _trace.span("finish"):
        X, Y, ok, pix, feas, obj = polished
        B = X.shape[0]
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=X.device)
        info = SolveInfo(
            converged=ok,
            status=torch.where(ok, SOLVE_CONVERGED, SOLVE_MAX_OUTER).to(torch.int32),
            outer_iters=zeros_i,
            inner_iters=torch.full_like(zeros_i, num_steps),
            pix=pix,
            feas=feas,
            mu=full(B, options.mu0, X),
            objective=obj,
            minor_iters=zeros_i.clone(),
            cg_iters=zeros_i.clone(),
        )
        if not host_any(~ok):
            return X, Y, info
        return fallback_full_refine(bp64, theta64, X, Y, info, options, chunk=chunk,
                                    fallback_device=fallback_device)


def fallback_full_refine(bp64, theta64, X: Tensor, Y: Tensor, info: SolveInfo, options, fallback_pad: int = 64,
                         chunk: int = 512, fallback_device=None):
    """Full-f64-refine fallback for the uncertified lanes (`info.converged`),
    warm-started from the polished points, with the stall-restart rescue
    (one more refine from its own output for the lanes the first refine
    left unconverged); results scattered back.  It runs on
    `fallback_device` when given (the data move there, and the results
    come back there), else where X is.  `fallback_pad` is refused at any
    value but 64 (`_check_fallback_pad`).  Its span is `fallback`
    (attribute `lanes`, `_trace`), from the lanes' gather on, with a
    `refine` span for each round."""
    from .refine import _cast_problem, refine_f64

    _check_fallback_pad("fallback_full_refine", fallback_pad)
    if fallback_device is not None:
        to = torch.device(fallback_device)
        bp64, theta64 = _cast_problem(bp64, torch.float64, to), tree_map(lambda a: a.to(to), theta64)
        X, Y, info = X.to(to), Y.to(to), SolveInfo(*[t.to(to) for t in info])
    idx = _gather_uncertified(info.converged)
    with _trace.span("fallback", lanes=idx.numel()):
        bp_f, theta_f = _take_batched(bp64, theta64, idx)
        with _trace.span("refine", lanes=idx.numel()):
            Xf, Yf, inf_f = refine_f64(bp_f, theta_f, X[idx], options, chunk=chunk)
        bad = ~inf_f.converged
        if host_any(bad):
            sel2 = _gather_uncertified(~bad)
            bp_r, theta_r = _take_batched(bp_f, theta_f, sel2)
            with _trace.span("refine", lanes=sel2.numel()):
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
