"""Projected conjugate gradients on the active-set tangent space (PyTorch
port of `benlsip_tpu/solver/cg.py`).

Approximately solves  min_w 1/2 wᵀHw + wᵀg  s.t. A w = 0, w_i = 0 (i fixed),
w_l ≤ w ≤ w_u, with early exits on bound hits and negative curvature; see
the JAX module for each deviation from the reference.  Batched: every lane
carries its own CG state and int32 status; a lane stops updating when its
status leaves CG_RUNNING.

`projected_cg` and `linesearch` run as written here for every operator
form but one: on the materialized R operator in float32 on a CUDA card
(`solver/inner.minor_on_kernel`), both are part of one kernel launch — of
`kernels.batched_linalg.minor_loop_r` for `inner_step`'s whole minor loop,
of `minor_direction_r` for one `minor_iterate` — whose plain versions are
`solver/inner`'s masked loop and its composition of these two functions.
`solver/qp.solve_qp` calls `projected_cg` directly, on every device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import full, norm, sel, vdot
from .._loops import masked_while
from ..ops.al import AlHessian, hv, vhv
from ..ops.constraints import ActiveSet, Polyhedron, nb_fix
from ..ops.project import project_tangent
from .status import CG_BOUND_HIT, CG_MAX_ITER, CG_NEGATIVE_CURVATURE, CG_RUNNING, CG_SOLVED

Tensor = torch.Tensor


def factor_to_boundary(p: Tensor, w: Tensor, w_l: Tensor, w_u: Tensor, atol: float = 1e-10) -> Tensor:
    """Largest gamma ≥ 0 per lane with w + gamma·p inside [w_l, w_u];
    components with |p_i| < atol don't bind."""
    lo = torch.where(p <= -atol, (w_l - w) / p, math.inf)
    hi = torch.where(p >= atol, (w_u - w) / p, math.inf)
    return torch.clamp_min(torch.minimum(lo.amin(-1), hi.amin(-1)), 0.0)


def linesearch(g_model: Tensor, H: AlHessian, w: Tensor, w_l: Tensor, w_u: Tensor, fixed: Tensor,
               axis: Optional[str] = None) -> Tensor:
    """Exact model line search along w, capped by the free-variable box."""
    wHw = vhv(H, w, axis)
    gw = vdot(g_model, w)
    alpha_opt = torch.where(wHw > 0, -gw / torch.where(wHw > 0, wHw, 1.0), math.inf)
    lo = torch.where(~fixed & (w < 0), w_l / torch.where(w < 0, w, 1.0), math.inf)
    hi = torch.where(~fixed & (w > 0), w_u / torch.where(w > 0, w, 1.0), math.inf)
    alpha = torch.minimum(alpha_opt, torch.minimum(lo.amin(-1), hi.amin(-1)))
    return torch.where(torch.isfinite(alpha), alpha, 1.0)


class _CGCarry(NamedTuple):
    w: Tensor
    r: Tensor
    v: Tensor
    p: Tensor
    rtv: Tensor
    it: Tensor
    status: Tensor


def projected_cg(
    g_minor: Tensor,
    H: AlHessian,
    w_l: Tensor,
    w_u: Tensor,
    poly: Polyhedron,
    aset: ActiveSet,
    kappa2: float,
    atol: Optional[float] = None,
    active: Optional[Tensor] = None,
    axis: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Projected CG with bound-hit / negative-curvature early exits.

    Returns (w, status, iters) per lane.  `active` (B,) restricts the
    iteration to the lanes an enclosing loop still runs; `axis` is the
    mesh dim H's rows are sharded over (`ops/al.hv`).
    """
    dtype = g_minor.dtype
    if atol is None:
        atol = torch.finfo(dtype).eps ** 0.5
    B, n = g_minor.shape
    m = poly.A.shape[-2]

    v0 = project_tangent(poly, aset, g_minor)
    eps_ = torch.finfo(dtype).eps
    noise_floor = (10.0 * eps_ * norm(g_minor)) ** 2
    tol_cg = torch.maximum((kappa2 * norm(v0)) ** 2, noise_floor)
    tol_nc = atol
    max_iter = 2 * (n - m - nb_fix(aset))

    def body(c: _CGCarry) -> _CGCarry:
        Hp = hv(H, c.p, axis)
        pHp = vdot(c.p, Hp)
        gamma = factor_to_boundary(c.p, c.w, w_l, w_u)
        gamma_safe = torch.where(torch.isfinite(gamma), gamma, 0.0)

        pp = vdot(c.p, c.p)
        neg = pHp <= tol_nc * pp
        nonzero_curv = torch.abs(pHp) > tol_nc * pp
        alpha = c.rtv / torch.where(neg, 1.0, pHp)
        outside = (~neg) & (alpha > gamma)
        interior = (~neg) & (~outside)

        step = torch.where(
            neg,
            torch.where(nonzero_curv, gamma_safe, 0.0),
            torch.where(outside, gamma, alpha),
        )
        w = c.w + step.unsqueeze(-1) * c.p

        r_new = c.r + alpha.unsqueeze(-1) * Hp
        v_new = project_tangent(poly, aset, r_new)
        rtv_next = vdot(v_new, v_new)
        beta = rtv_next / torch.where(c.rtv != 0, c.rtv, 1.0)
        p_new = -v_new + beta.unsqueeze(-1) * c.p

        r = sel(interior, r_new, c.r)
        v = sel(interior, v_new, c.v)
        p = sel(interior, p_new, c.p)
        rtv = torch.where(interior, rtv_next, c.rtv)
        it = c.it + interior.to(torch.int32)

        approx_solved = interior & (torch.abs(rtv_next) < tol_cg)
        status = torch.where(
            neg,
            CG_NEGATIVE_CURVATURE,
            torch.where(
                outside,
                CG_BOUND_HIT,
                torch.where(
                    approx_solved,
                    CG_SOLVED,
                    torch.where(it > max_iter, CG_MAX_ITER, CG_RUNNING),
                ),
            ),
        ).to(torch.int32)
        return _CGCarry(w, r, v, p, rtv, it, status)

    rtv0 = vdot(v0, v0)
    c = _CGCarry(
        w=torch.zeros_like(g_minor),
        r=g_minor,
        v=v0,
        p=-v0,
        rtv=rtv0,
        it=full(B, 1, rtv0, torch.int32),
        status=torch.where(
            rtv0 <= tol_cg,
            CG_SOLVED,
            torch.where(max_iter >= 1, CG_RUNNING, CG_MAX_ITER),
        ).to(torch.int32),
    )
    # The JAX loop's static trip bound 2(n - m) skips it entirely when ≤ 0;
    # `it` caps the trips at 2(n - m - #fix) + 1.
    if 2 * (n - m) > 0:
        run = c.status == CG_RUNNING
        if active is not None:
            run = run & active
        c = masked_while(lambda c: c.status == CG_RUNNING, lambda c, act: body(c), c, run, 2 * (n - m) + 1)
    return c.w, c.status, c.it - 1
