"""Problem transforms: inequality constraints via slack variables (PyTorch
port of `benlsip_tpu/solver/transforms.py`).

The solver handles equality-constrained NLS with bounds; the classical
reduction makes inequalities solvable by the same machinery with no solver
change:

    g(x) ≥ 0        →   g(x) − s = 0,   s ≥ 0      (nonlinear, slack s)
    G x ≥ h         →   G x − t = h,    t ≥ 0      (linear, slack t)

The lifted variable z = [x; s; t] keeps the problem's structure: static
shapes (q and ℓ are fixed), the polyhedron stays {A_z z = b_z, l ≤ z ≤ u}
(slack bounds are just more box bounds for the masked active-set
machinery), and the Jacobian blocks are zero-padded.  Slack columns add
q+ℓ to n.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import as_tensor
from .api import Problem, autodiff_jacobian

Tensor = torch.Tensor


class LiftedProblem(NamedTuple):
    """Result of `with_inequalities`.

    problem: the equality-form `Problem` over z = [x; s; t].
    z0:      feasible-start lift of x0 (slacks initialized at
             max(g(x0), 0) / max(Gx0 − h, 0) — exactly on their bound
             whenever the inequality is active or violated at x0; the
             active-set machinery handles on-bound starts natively, so
             no interior push is applied).
    unlift:  z ↦ x (drops the slack block; works on batched z too).
    slacks:  z ↦ (s, t) — the inequality activities at a solution
             (g_i active ⟺ s_i = 0, same for t).
    """

    problem: Problem
    z0: Tensor
    unlift: Callable[[Tensor], Tensor]
    slacks: Callable[[Tensor], Tuple[Tensor, Tensor]]


def with_inequalities(
    problem: Problem,
    x0,
    nl_ineq: Optional[Callable[[Tensor], Tensor]] = None,
    jac_ineq: Optional[Callable[[Tensor], Tensor]] = None,
    G=None,
    h=None,
    device=None,
) -> LiftedProblem:
    """Lift `problem` + inequalities into pure equality/bound form.

    nl_ineq: x ↦ g(x) ∈ ℝ^q enforced as g(x) ≥ 0 (autodiff Jacobian when
    jac_ineq is None); G, h: linear rows enforced as G x ≥ h.  Either or
    both may be given.  Returns a `LiftedProblem` whose `problem` solves
    with the standard `solve`/batched entries; `unlift` recovers x.  The
    lifted data live on x0's device (a list or numpy x0 is created on
    `device`; None is the CUDA card).

    At a KKT point of the lifted problem the multiplier of the i-th slack
    equality is the inequality's multiplier, and the slack's bound
    activity (s_i = 0) marks the inequality active — the standard
    correspondence, so certificates transfer unchanged.
    """
    if nl_ineq is None and G is None:
        raise ValueError("with_inequalities: give nl_ineq and/or (G, h)")
    if G is None and h is not None:
        raise ValueError(
            "with_inequalities: h given without G — the linear rows Gx ≥ h "
            "need both; a mis-keyed call would otherwise silently drop them"
        )
    if nl_ineq is None and jac_ineq is not None:
        raise ValueError("with_inequalities: jac_ineq given without nl_ineq")
    x0 = as_tensor(x0, device=device)
    n = x0.shape[-1]
    kw = {"dtype": x0.dtype, "device": x0.device}
    if nl_ineq is not None:
        # Accept a scalar-returning single constraint (the natural way to
        # write one inequality) by promoting to a length-1 vector.
        user_g = nl_ineq
        nl_ineq = lambda x: torch.atleast_1d(user_g(x))
        g0 = nl_ineq(x0)
        q = g0.shape[0]
    else:
        q = 0
    if G is not None:
        if h is None:
            raise ValueError("with_inequalities: G given without h")
        G = as_tensor(G, **kw)
        h = as_tensor(h, **kw)
        ell = G.shape[0]
    else:
        ell = 0

    def split(z):
        return z[..., :n], z[..., n:n + q], z[..., n + q:]

    # Residuals see only x; their Jacobian gets q+ℓ zero columns.
    user_jr = problem.jac_res or autodiff_jacobian(problem.residuals)

    def residuals_z(z):
        return problem.residuals(split(z)[0])

    def jac_res_z(z):
        Jr = user_jr(split(z)[0])
        return torch.cat([Jr, Jr.new_zeros(Jr.shape[:-1] + (q + ell,))], dim=-1)

    # Equality block: [c(x); g(x) − s]  (t appears only in the linear rows).
    user_c = problem.nlconstraints
    if user_c is not None:
        user_jc = problem.jac_nlcons or autodiff_jacobian(user_c)
    if nl_ineq is not None:
        # atleast_2d mirrors the scalar-constraint promotion above for a
        # hand-coded (n,)-shaped single-row Jacobian.
        user_jg = (
            (lambda x: torch.atleast_2d(jac_ineq(x)))
            if jac_ineq is not None
            else autodiff_jacobian(nl_ineq)
        )

    def nlconstraints_z(z):
        x, s, _ = split(z)
        parts = [] if user_c is None else [user_c(x)]
        if nl_ineq is not None:
            parts.append(nl_ineq(x) - s)
        return torch.cat(parts, dim=-1)

    def jac_nlcons_z(z):
        x, _, _ = split(z)
        rows = []
        if user_c is not None:
            C = user_jc(x)
            rows.append(torch.cat([C, C.new_zeros((C.shape[0], q + ell))], dim=-1))
        if nl_ineq is not None:
            Jg = user_jg(x)
            rows.append(torch.cat([Jg, -torch.eye(q, dtype=Jg.dtype, device=Jg.device), Jg.new_zeros((q, ell))], dim=-1))
        return torch.cat(rows, dim=0)

    has_nl = user_c is not None or nl_ineq is not None

    # Linear block: [A 0 0; G 0 −I] z = [b; h].
    A = as_tensor(problem.A, **kw) if problem.A is not None else torch.zeros((0, n), **kw)
    b = as_tensor(problem.b, **kw) if problem.b is not None else torch.zeros((A.shape[0],), **kw)
    m = A.shape[0]
    A_z = torch.cat([A, torch.zeros((m, q + ell), **kw)], dim=-1)
    b_z = b
    if ell:
        G_row = torch.cat([G, torch.zeros((ell, q), **kw), -torch.eye(ell, **kw)], dim=-1)
        A_z = torch.cat([A_z, G_row], dim=0)
        b_z = torch.cat([b_z, h], dim=-1)

    xl = as_tensor(problem.xl, **kw) if problem.xl is not None else torch.full((n,), -float("inf"), **kw)
    xu = as_tensor(problem.xu, **kw) if problem.xu is not None else torch.full((n,), float("inf"), **kw)
    zl = torch.cat([xl, torch.zeros((q + ell,), **kw)], dim=-1)
    zu = torch.cat([xu, torch.full((q + ell,), float("inf"), **kw)], dim=-1)

    lifted = Problem(
        residuals=residuals_z,
        nlconstraints=nlconstraints_z if has_nl else None,
        jac_res=jac_res_z,
        jac_nlcons=jac_nlcons_z if has_nl else None,
        A=A_z,
        b=b_z,
        xl=zl,
        xu=zu,
    )

    # Feasible-start lift: slacks at their activities, floored at 0 so the
    # box holds; solve()'s project_x0 then restores A_z z = b_z exactly.
    s0 = torch.clamp_min(g0, 0.0) if nl_ineq is not None else torch.zeros((0,), **kw)
    t0 = torch.clamp_min(G @ x0 - h, 0.0) if ell else torch.zeros((0,), **kw)
    z0 = torch.cat([x0, s0.to(**kw), t0], dim=-1)

    return LiftedProblem(
        problem=lifted,
        z0=z0,
        unlift=lambda z: z[..., :n],
        slacks=lambda z: (z[..., n:n + q], z[..., n + q:]),
    )
