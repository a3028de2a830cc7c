"""Inner step: Cauchy search + active-set minor iterations (PyTorch port of
`benlsip_tpu/solver/inner.py`).

Both loops are masked state machines over an immutable bool mask; each
activation refreshes the m×m masked factor (`ops/cholesky.py`, the
Cholesky kernel for float32).  Every function takes an `active` (B,) mask:
the lanes the enclosing trust-region loop still runs.  Other lanes return
unspecified values, which the caller selects away.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import full, norm, sel, sel_tuple, vdot
from ..ops.al import AlHessian, hv, vhv
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
from .status import CG_NEGATIVE_CURVATURE

Tensor = torch.Tensor


def _all(B: int, like: Tensor) -> Tensor:
    return torch.ones((B,), dtype=torch.bool, device=like.device)


def next_breakpoint(d: Tensor, s: Tensor, d_l: Tensor, d_u: Tensor, fixed: Tensor) -> Tuple[Tensor, Tensor]:
    """Smallest theta per lane with a free component of s + theta·d at a
    bound: (theta, index); theta = +inf when no free direction moves."""
    inf = torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    theta_i = torch.where(
        d < 0,
        (d_l - s) / torch.where(d < 0, d, 1.0),
        torch.where(d > 0, (d_u - s) / torch.where(d > 0, d, 1.0), inf),
    )
    theta_i = torch.where(fixed, inf, theta_i)
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
    chol_reg: float = 0.0, active: Optional[Tensor] = None,
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
    Hd0 = hv(H, d0)
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

    def body(c: _CauchyCarry) -> _CauchyCarry:
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
        Hd_new = hv(H, d_new)
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

    if n - m > 0:  # the JAX loop's static trip bound
        run = cond(c) if active is None else active & cond(c)
        while bool(run.any()):
            c = sel_tuple(run, body(c), c)
            run = run & cond(c)
    return c.s, ActiveSet(fixed=c.fixed, chol=c.chol)


def minor_iterate(
    x: Tensor, s: Tensor, g_minor: Tensor, H: AlHessian, poly: Polyhedron, aset: ActiveSet,
    delta: Tensor, kappa2: float, active: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One minor iteration: projected-CG direction + model line search.
    The remaining trust-region/bound gap constrains the free variables."""
    free = ~aset.fixed
    dl = delta.unsqueeze(-1)
    w_u = torch.where(free, torch.minimum(poly.xu - x, dl) - s, 0.0)
    w_l = torch.where(free, torch.maximum(poly.xl - x, -dl) - s, 0.0)
    w_u = torch.clamp_min(w_u, 0.0)
    w_l = torch.clamp_max(w_l, 0.0)

    w, cg_status, cg_iters = projected_cg(g_minor, H, w_l, w_u, poly, aset, kappa2, active=active)
    alpha = linesearch(g_minor, H, w, w_l, w_u, aset.fixed)
    w = sel(cg_status != CG_NEGATIVE_CURVATURE, alpha.unsqueeze(-1) * w, w)
    return w, cg_status, cg_iters


def cauchy_step_projected(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, atol: float,
    kappa1: float = 1e-2, gamma_c: float = 10.0, max_trials: int = 16,
    chol_reg: float = 0.0, active: Optional[Tensor] = None,
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
    gHg = vhv(H, g)
    gg = vdot(g, g)
    t0 = torch.where(gHg > 0, gg / torch.where(gHg > 0, gHg, 1.0), 1.0)

    def trial(t, act):
        s = projection_polyhedron(seg, -t.unsqueeze(-1) * g, active=act)
        gts = vdot(g, s)
        qs = 0.5 * vhv(H, s) + gts
        return s, qs <= kappa1 * gts

    s, ok = trial(t0, active)
    t, k = t0 / gamma_c, full(B, 1, t0, torch.int32)
    run = active & ~ok & (k < max_trials)
    while bool(run.any()):
        s_new, ok_new = trial(t, run)
        s = sel(run, s_new, s)
        ok = torch.where(run, ok_new, ok)
        t = torch.where(run, t / gamma_c, t)
        k = torch.where(run, k + 1, k)
        run = run & ~ok & (k < max_trials)
    fixed = step_active_bounds(poly, x, s, delta, atol)
    return s, make_active_set(poly, fixed, reg=chol_reg)


class _MinorCarry(NamedTuple):
    s: Tensor
    g_minor: Tensor
    fixed: Tensor
    chol: Tensor
    j: Tensor
    cg_total: Tensor
    approx_solved: Tensor
    cg_stop: Tensor


class InnerStats(NamedTuple):
    """Trip counts of one inner step per lane."""

    minor_iters: Tensor
    cg_iters: Tensor


def inner_step(
    x: Tensor, g: Tensor, H: AlHessian, poly: Polyhedron, delta: Tensor, opts, atol: float,
    active: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, ActiveSet, InnerStats]:
    """Cauchy step + active-set refinement minor iterations.

    Returns (s, model_reduction, final_active_set, stats); the model
    reduction pred = gᵀs + 1/2 sᵀHs is negative for improvement.
    """
    B, n = x.shape
    m = poly.A.shape[-2]
    if active is None:
        active = _all(B, x)
    chol_reg = opts.chol_reg

    if n - m > opts.projected_cauchy_threshold:
        s0, aset0 = cauchy_step_projected(
            x, g, H, poly, delta, atol,
            kappa1=opts.kappa1, gamma_c=opts.gamma_c,
            max_trials=opts.cauchy_max_trials, chol_reg=chol_reg, active=active,
        )
    else:
        s0, aset0 = cauchy_step(x, g, H, poly, delta, atol, chol_reg, active=active)
    g_minor0 = hv(H, s0) + g

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
        cg_stop=full(B, False, nrg0, torch.bool),
    )

    def cond(c: _MinorCarry):
        return (c.j <= max_minor) & (~c.approx_solved) & (~c.cg_stop)

    def body(c: _MinorCarry, act: Tensor) -> _MinorCarry:
        aset = ActiveSet(fixed=c.fixed, chol=c.chol)
        w, cg_status, cg_iters = minor_iterate(
            x, c.s, c.g_minor, H, poly, aset, delta, opts.kappa2, active=act
        )
        cg_stop = cg_status == CG_NEGATIVE_CURVATURE
        s = c.s + w
        g_minor = hv(H, s) + g

        at_bound = step_active_bounds(poly, x, s, delta, atol)
        union_fixed = c.fixed | at_bound
        fits = m + union_fixed.sum(-1) <= n
        fixed = sel(fits, union_fixed, active_bounds_at(poly, x + s, atol))
        aset_next = make_active_set(poly, fixed, reg=chol_reg)

        nrg = norm_reduced_gradient(poly, aset_next, g)
        nrgm = norm_reduced_gradient(poly, aset_next, g_minor)
        approx_solved = torch.where(fits, nrgm <= opts.kappa3 * nrg, True)
        return _MinorCarry(
            s, g_minor, fixed, aset_next.chol, c.j + 1, c.cg_total + cg_iters,
            approx_solved, cg_stop,
        )

    if min(opts.max_minor_iter, n - m) > 0:  # the JAX loop's static trip bound
        run = active & cond(c)
        while bool(run.any()):
            c = sel_tuple(run, body(c, run), c)
            run = run & cond(c)
    pred = vdot(g, c.s) + 0.5 * vhv(H, c.s)
    stats = InnerStats(minor_iters=c.j - 1, cg_iters=c.cg_total)
    return c.s, pred, ActiveSet(fixed=c.fixed, chol=c.chol), stats
