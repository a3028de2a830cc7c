"""Inner step: Cauchy search + active-set minor iterations (PyTorch port of
`benlsip_tpu/solver/inner.py`).

Both loops are masked state machines over an immutable bool mask; each
activation refreshes the m×m masked factor (`ops/cholesky.py`, the
Cholesky kernel for float32).  Every function takes an `active` (B,) mask:
the lanes the enclosing trust-region loop still runs.  Other lanes return
unspecified values, which the caller selects away.

On the materialized operator R (RᵀR = H, the dense families' CholeskyQR2
route) in float32 on a CUDA card, whole and without a mesh axis, the whole
minor loop of an inner step — each trip's box, projected CG and line search,
the step's gradient, the bound masks, the re-factor and the reduced-gradient
test, each lane to its own exit — is one launch of
`kernels.batched_linalg.minor_loop_r` (`minor_on_kernel` decides from the
inputs alone); a minor iteration alone (`minor_iterate`) is one launch of
`kernels.batched_linalg.minor_direction_r` there.  Every other operator
form (J, G, row-sharded R or G), dtype, device or size runs the masked loop
below over the composition of `solver/cg`; the loop is the loop kernel's
plain version (`minor_loop_r_plain`), the composition the iteration
kernel's (`minor_direction_r_plain`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import full, norm, sel, vdot
from .._loops import masked_while
from ..kernels import batched_linalg as kern
from ..ops.al import AlHessian, hv, vhv
from ..ops.cholesky import _row_major_blocks
from ..ops.constraints import (
    ActiveSet,
    Polyhedron,
    active_bounds_at,
    binding_bounds_coupled,
    make_active_set,
    nb_fix,
    step_active_bounds,
)
from ..ops.project import norm_reduced_gradient, project_tangent
from .cg import linesearch, projected_cg
from .status import CG_NEGATIVE_CURVATURE, CG_RUNNING

Tensor = torch.Tensor


def _all(B: int, like: Tensor) -> Tensor:
    return torch.ones((B,), dtype=torch.bool, device=like.device)


def next_breakpoint(d: Tensor, s: Tensor, d_l: Tensor, d_u: Tensor, fixed: Tensor) -> Tuple[Tensor, Tensor]:
    """Smallest theta per lane with a free component of s + theta·d at a
    bound: (theta, index); theta = +inf when no free direction moves."""
    theta_i = torch.where(
        d < 0,
        (d_l - s) / torch.where(d < 0, d, 1.0),
        torch.where(d > 0, (d_u - s) / torch.where(d > 0, d, 1.0), math.inf),
    )
    theta_i = torch.where(fixed, math.inf, theta_i)
    ind = torch.argmin(theta_i, dim=-1)   # first index on ties, like jnp.argmin
    return theta_i.gather(-1, ind.unsqueeze(-1)).squeeze(-1), ind


class _CauchyCarry(NamedTuple):
    s: Tensor
    fixed: Tensor
    chol: Tensor
    d: Tensor
    Hd: Tensor
    phi_p: Tensor
    phi_pp: Tensor
    done: Tensor


def cauchy_step(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, atol: float,
    chol_reg: float = 0.0, active: Optional[Tensor] = None, axis: Optional[str] = None,
) -> Tuple[Tensor, ActiveSet]:
    """First local minimum of the model along the projected-gradient path
    (the breakpoint walk): returns (s_c, active set after the walk)."""
    dtype = x.dtype
    B, n = x.shape
    m = poly.A.shape[-2]

    fixed0 = binding_bounds_coupled(poly, x, g, atol, reg=chol_reg)
    aset0 = make_active_set(poly, fixed0, reg=chol_reg)
    d0 = project_tangent(poly, aset0, -g)

    dl = delta.unsqueeze(-1)
    d_u = torch.minimum(poly.xu - x, dl)
    d_l = torch.maximum(poly.xl - x, -dl)

    # Slope phi' = sᵀHd + gᵀd with gᵀd = -‖d‖² exactly (d = P(-g)).
    Hd0 = hv(H, d0, axis)
    c = _CauchyCarry(
        s=torch.zeros_like(x),
        fixed=fixed0,
        chol=aset0.chol,
        d=d0,
        Hd=Hd0,
        phi_p=-vdot(d0, d0),
        phi_pp=vdot(d0, Hd0),
        done=norm(d0) <= 10.0 * torch.finfo(dtype).eps * norm(g),
    )

    def cond(c: _CauchyCarry):
        return (~c.done) & (c.fixed.sum(-1) < n - m)

    def body(c: _CauchyCarry, act: Tensor) -> _CauchyCarry:
        theta, ind = next_breakpoint(c.d, c.s, d_l, d_u, c.fixed)
        delta_t = torch.where(c.phi_pp > 0, -c.phi_p / torch.where(c.phi_pp > 0, c.phi_pp, 1.0), 0.0)

        at_min = c.phi_p >= 0
        interior_min = (c.phi_p < 0) & (c.phi_pp > 0) & (delta_t < theta)
        advance = (~at_min) & (~interior_min)

        theta_safe = torch.where(torch.isfinite(theta), theta, 0.0)
        s = torch.where(
            at_min.unsqueeze(-1),
            c.s,
            torch.where(
                interior_min.unsqueeze(-1),
                c.s + delta_t.unsqueeze(-1) * c.d,
                c.s + theta_safe.unsqueeze(-1) * c.d,
            ),
        )
        fixed = sel(advance, c.fixed.scatter(-1, ind.unsqueeze(-1), True), c.fixed)
        aset = make_active_set(poly, fixed, reg=chol_reg)
        d_new = project_tangent(poly, aset, -g)
        Hd_new = hv(H, d_new, axis)
        return _CauchyCarry(
            s,
            fixed,
            sel(advance, aset.chol, c.chol),
            sel(advance, d_new, c.d),
            sel(advance, Hd_new, c.Hd),
            torch.where(advance, vdot(s, Hd_new) - vdot(d_new, d_new), c.phi_p),
            torch.where(advance, vdot(d_new, Hd_new), c.phi_pp),
            at_min | interior_min,
        )

    # Each trip fixes one more coordinate or ends the walk: at most n - m.
    if n - m > 0:
        run = cond(c) if active is None else active & cond(c)
        c = masked_while(cond, body, c, run, n - m)
    return c.s, ActiveSet(fixed=c.fixed, chol=c.chol)


def minor_on_kernel(device_type: str, H: AlHessian, dtype: torch.dtype, m: int, axis: Optional[str]) -> bool:
    """Whether a minor iteration of `dtype` on a device of `device_type` runs
    the minor-iteration kernel: CUDA, float32, no mesh axis, H materialized
    as R whole (neither R nor G row-sharded) in float32, and R (k, n) with m
    equalities within the kernel (`kern.minor_direction_fits`: 0 < m ≤ 16,
    n ≤ 256 and its shared memory; at k = n, n ≤ 230).  A gate on the
    inputs, not a fallback: the kernel launches or raises."""
    R = H.R
    return (device_type == "cuda" and dtype == torch.float32 and axis is None and R is not None
            and H.R_rows is None and H.G_rows is None and R.dtype == torch.float32
            and kern.minor_direction_fits(R.shape[-2], m, R.shape[-1]))


def minor_iterate(
    x: Tensor, s: Tensor, g_minor: Tensor, H: AlHessian, poly: Polyhedron, aset: ActiveSet,
    delta: Tensor, kappa2: float, active: Optional[Tensor] = None, axis: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One minor iteration: projected-CG direction + model line search.
    The remaining trust-region/bound gap constrains the free variables.
    One launch of the minor-iteration kernel where `minor_on_kernel` says
    so, else the composition of `solver/cg`."""
    if minor_on_kernel(x.device.type, H, x.dtype, poly.A.shape[-2], axis):
        return kern.minor_direction_r(
            H.R.contiguous(), _row_major_blocks(poly.A), aset.chol.contiguous(), aset.fixed.contiguous(),
            x.contiguous(), s.contiguous(), g_minor.contiguous(), kern.unit_rows(poly.xl), kern.unit_rows(poly.xu),
            delta.contiguous(), kappa2, active=None if active is None else active.contiguous(),
        )
    return _minor_composed(x, s, g_minor, H, poly, aset, delta, kappa2, active, axis)


def _minor_composed(
    x: Tensor, s: Tensor, g_minor: Tensor, H: AlHessian, poly: Polyhedron, aset: ActiveSet,
    delta: Tensor, kappa2: float, active: Optional[Tensor], axis: Optional[str],
) -> Tuple[Tensor, Tensor, Tensor]:
    free = ~aset.fixed
    dl = delta.unsqueeze(-1)
    w_u = torch.where(free, torch.minimum(poly.xu - x, dl) - s, 0.0)
    w_l = torch.where(free, torch.maximum(poly.xl - x, -dl) - s, 0.0)
    w_u = torch.clamp_min(w_u, 0.0)
    w_l = torch.clamp_max(w_l, 0.0)

    w, cg_status, cg_iters = projected_cg(g_minor, H, w_l, w_u, poly, aset, kappa2, active=active, axis=axis)
    alpha = linesearch(g_minor, H, w, w_l, w_u, aset.fixed, axis=axis)
    w = sel(cg_status != CG_NEGATIVE_CURVATURE, alpha.unsqueeze(-1) * w, w)
    return w, cg_status, cg_iters


def minor_direction_r_plain(R: Tensor, A: Tensor, L: Tensor, fixed: Tensor, x: Tensor, s: Tensor, g: Tensor,
                            xl: Tensor, xu: Tensor, delta: Tensor, kappa2: float,
                            active: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The minor-iteration kernel's plain version (`kern.minor_direction_r`
    on CPU tensors): `minor_iterate`'s composition on H = RᵀR, the
    polyhedron's A and bounds and the active set (fixed, L)."""
    H = AlHessian(None, None, None, R=R)
    poly = Polyhedron(A, None, xl, xu)
    return _minor_composed(x, s, g, H, poly, ActiveSet(fixed=fixed, chol=L), delta, kappa2, active, None)


def cauchy_step_projected(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, atol: float,
    kappa1: float = 1e-2, gamma_c: float = 10.0, max_trials: int = 16,
    chol_reg: float = 0.0, active: Optional[Tensor] = None, axis: Optional[str] = None,
) -> Tuple[Tensor, ActiveSet]:
    """Projected-search Cauchy step: backtracking along s(t) = P(x - t·g) - x
    with exact projections, accepted at the first t with sufficient
    decrease (the path `inner_step` takes when n - m is large)."""
    from ..ops.polyproject import projection_polyhedron

    B = x.shape[0]
    if active is None:
        active = _all(B, x)
    dl = delta.unsqueeze(-1)
    seg = Polyhedron(
        A=poly.A, b=torch.zeros_like(poly.b),
        xl=torch.maximum(poly.xl - x, -dl), xu=torch.minimum(poly.xu - x, dl),
    )
    gHg = vhv(H, g, axis)
    gg = vdot(g, g)
    t0 = torch.where(gHg > 0, gg / torch.where(gHg > 0, gHg, 1.0), 1.0)

    def trial(t, act):
        s = projection_polyhedron(seg, -t.unsqueeze(-1) * g, active=act)
        gts = vdot(g, s)
        qs = 0.5 * vhv(H, s, axis) + gts
        return s, qs <= kappa1 * gts

    def body(c: _TrialCarry, act: Tensor) -> _TrialCarry:
        s_new, ok_new = trial(c.t, act)
        return _TrialCarry(s_new, ok_new, c.t / gamma_c, c.k + 1)

    s, ok = trial(t0, active)
    c = _TrialCarry(s, ok, t0 / gamma_c, full(B, 1, t0, torch.int32))
    # k counts the trials: at most max_trials - 1 after the first.
    c = masked_while(lambda c: ~c.ok & (c.k < max_trials), body, c, active & ~ok & (c.k < max_trials), max_trials)
    s = c.s
    fixed = step_active_bounds(poly, x, s, delta, atol)
    return s, make_active_set(poly, fixed, reg=chol_reg)


class _TrialCarry(NamedTuple):
    s: Tensor
    ok: Tensor
    t: Tensor
    k: Tensor


class _MinorCarry(NamedTuple):
    s: Tensor
    g_minor: Tensor
    fixed: Tensor
    chol: Tensor
    j: Tensor
    cg_total: Tensor
    approx_solved: Tensor
    cg_status: Tensor


class InnerStats(NamedTuple):
    """Trip counts of one inner step per lane."""

    minor_iters: Tensor
    cg_iters: Tensor


def _minor_cond(c: _MinorCarry, max_minor: Tensor) -> Tensor:
    return (c.j <= max_minor) & (~c.approx_solved) & (c.cg_status != CG_NEGATIVE_CURVATURE)


def _minor_loop(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, c: _MinorCarry, max_minor: Tensor,
    run: Tensor, trip_cap: int, kappa2: float, kappa3: float, atol: float, chol_reg: float, axis: Optional[str],
) -> _MinorCarry:
    """The active-set refinement loop from carry c, the lanes in `run` at
    entry, each to its own exit (`_minor_cond`): a minor iteration, the
    step's model gradient, the bounds it hit added to the fixed set (or,
    where the union leaves no room for the equalities, the bounds active at
    x + s, and the lane stops), the set's factor and the reduced-gradient
    test."""
    B, n = x.shape
    m = poly.A.shape[-2]

    def body(c: _MinorCarry, act: Tensor) -> _MinorCarry:
        aset = ActiveSet(fixed=c.fixed, chol=c.chol)
        w, cg_status, cg_iters = minor_iterate(
            x, c.s, c.g_minor, H, poly, aset, delta, kappa2, active=act, axis=axis
        )
        s = c.s + w
        g_minor = hv(H, s, axis) + g

        at_bound = step_active_bounds(poly, x, s, delta, atol)
        union_fixed = c.fixed | at_bound
        fits = m + union_fixed.sum(-1) <= n
        fixed = sel(fits, union_fixed, active_bounds_at(poly, x + s, atol))
        aset_next = make_active_set(poly, fixed, reg=chol_reg)

        nrg = norm_reduced_gradient(poly, aset_next, g)
        nrgm = norm_reduced_gradient(poly, aset_next, g_minor)
        approx_solved = torch.where(fits, nrgm <= kappa3 * nrg, True)
        return _MinorCarry(
            s, g_minor, fixed, aset_next.chol, c.j + 1, c.cg_total + cg_iters,
            approx_solved, cg_status,
        )

    return masked_while(lambda c: _minor_cond(c, max_minor), body, c, run, trip_cap)


def minor_loop_r_plain(R: Tensor, A: Tensor, L: Tensor, fixed: Tensor, x: Tensor, s: Tensor, g: Tensor,
                       g_minor: Tensor, xl: Tensor, xu: Tensor, delta: Tensor, run: Optional[Tensor],
                       max_minor: Tensor, kappa2: float, kappa3: float, atol: float, reg: float = 0.0):
    """The minor-loop kernel's plain version (`kern.minor_loop_r` on CPU
    tensors): `inner_step`'s masked loop on H = RᵀR, the polyhedron's A and
    bounds, from the carry (s, g_minor, fixed, L) with the lanes in `run`
    at entry.  Returns (s, g_minor, fixed, L, trips, CG trips, the last
    trip's CG status)."""
    B, n = x.shape
    H = AlHessian(None, None, None, R=R)
    poly = Polyhedron(A, None, xl, xu)
    one = full(B, 1, delta, torch.int32)
    c = _MinorCarry(s, g_minor, fixed, L, one, one - 1, full(B, False, delta, torch.bool),
                    full(B, CG_RUNNING, delta, torch.int32))
    if run is None:
        run = _all(B, x)
    c = _minor_loop(x, g, H, poly, delta, c, max_minor, run, n - A.shape[-2], kappa2, kappa3, atol, reg, None)
    return c.s, c.g_minor, c.fixed, c.chol, c.j - 1, c.cg_total, c.cg_status


def inner_step(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, opts, atol: float,
    active: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, ActiveSet, InnerStats]:
    """Cauchy step + active-set refinement minor iterations.

    Returns (s, model_reduction, final_active_set, stats); the model
    reduction pred = gᵀs + 1/2 sᵀHs is negative for improvement.  Every
    product with H is summed over `opts.spmd_axis`.  The minor loop is one
    launch of the minor-loop kernel where `minor_on_kernel` says so, else
    the masked loop of `_minor_loop`.
    """
    B, n = x.shape
    m = poly.A.shape[-2]
    if active is None:
        active = _all(B, x)
    chol_reg = opts.chol_reg
    ax = opts.spmd_axis

    if n - m > opts.projected_cauchy_threshold:
        s0, aset0 = cauchy_step_projected(
            x, g, H, poly, delta, atol,
            kappa1=opts.kappa1, gamma_c=opts.gamma_c,
            max_trials=opts.cauchy_max_trials, chol_reg=chol_reg, active=active, axis=ax,
        )
    else:
        s0, aset0 = cauchy_step(x, g, H, poly, delta, atol, chol_reg, active=active, axis=ax)
    g_minor0 = hv(H, s0, ax) + g

    nrg0 = norm_reduced_gradient(poly, aset0, g)
    nrgm0 = norm_reduced_gradient(poly, aset0, g_minor0)
    allowed = torch.clamp_min(n - m - nb_fix(aset0), 0)
    max_minor = torch.clamp_max(allowed, opts.max_minor_iter)

    c = _MinorCarry(
        s=s0,
        g_minor=g_minor0,
        fixed=aset0.fixed,
        chol=aset0.chol,
        j=full(B, 1, nrg0, torch.int32),
        cg_total=full(B, 0, nrg0, torch.int32),
        approx_solved=nrgm0 <= opts.kappa3 * nrg0,
        cg_status=full(B, CG_RUNNING, nrg0, torch.int32),
    )
    # j caps the trips at max_minor ≤ min(max_minor_iter, n - m).
    trip_cap = min(opts.max_minor_iter, n - m)
    if trip_cap > 0 and minor_on_kernel(x.device.type, H, x.dtype, m, ax):
        s, _, fixed, chol, minor_iters, cg_iters, _ = kern.minor_loop_r(
            H.R.contiguous(), _row_major_blocks(poly.A), c.chol.contiguous(), c.fixed.contiguous(), x.contiguous(),
            c.s.contiguous(), g.contiguous(), c.g_minor.contiguous(), kern.unit_rows(poly.xl), kern.unit_rows(poly.xu),
            delta.contiguous(), active & _minor_cond(c, max_minor), max_minor.contiguous(), opts.kappa2, opts.kappa3,
            atol, chol_reg,
        )
    else:
        if trip_cap > 0:
            c = _minor_loop(x, g, H, poly, delta, c, max_minor, active & _minor_cond(c, max_minor), trip_cap,
                            opts.kappa2, opts.kappa3, atol, chol_reg, ax)
        s, fixed, chol, minor_iters, cg_iters = c.s, c.fixed, c.chol, c.j - 1, c.cg_total
    pred = vdot(g, s) + 0.5 * vhv(H, s, ax)
    stats = InnerStats(minor_iters=minor_iters, cg_iters=cg_iters)
    return s, pred, ActiveSet(fixed=fixed, chol=chol), stats


kern.set_minor_plain(minor_direction_r_plain)
kern.set_minor_loop_plain(minor_loop_r_plain)
