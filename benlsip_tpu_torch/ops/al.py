"""Augmented-Lagrangian evaluation and the Gauss-Newton Hessian operator
(PyTorch port of `benlsip_tpu/ops/al.py`).

* m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc
* g(x) = Jᵀr + Cᵀ(y + mu c)
* H    = JᵀJ + mu CᵀC, held as the triple (J, C, mu) and optionally
  materialized as an (n, n) operator: the Gram matrix G (`with_gram`) or
  a triangular R with RᵀR = H (`with_r_factor` by QR,
  `with_r_factor_cholqr2` by CholeskyQR2).  The solver materializes one
  when the Jacobian is tall (`solver/subproblem.resolve_operator_route`).

Only the replicated layout is ported; the row-sharded layouts of the JAX
module (`with_gram_rows`, `gram_j_rows`, `R_rows`) wait for `dist/`.
p == 0 (no nonlinear constraints) is carried as a zero-row C.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import mtv, mv, vdot

Tensor = torch.Tensor


class AlHessian(NamedTuple):
    """Gauss-Newton Hessian H = JᵀJ + mu CᵀC, batched: the factors, and
    optionally the materialized Gram matrix G or a factor R with RᵀR = H."""

    J: Tensor   # (B, d, n)
    C: Tensor   # (B, p, n), p may be 0
    mu: Tensor  # (B,)
    G: Optional[Tensor] = None  # (B, n, n) JᵀJ + mu CᵀC
    R: Optional[Tensor] = None  # (B, k, n) R of [J; sqrt(mu) C]


def al_value(rx: Tensor, cx: Tensor, y: Tensor, mu: Tensor) -> Tensor:
    """m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc per lane."""
    return 0.5 * vdot(rx, rx) + vdot(y, cx) + 0.5 * mu * vdot(cx, cx)


def al_gradient(J: Tensor, C: Tensor, rx: Tensor, y_bar: Tensor) -> Tensor:
    """g = Jᵀ rx + Cᵀ y_bar with y_bar = y + mu c."""
    return mtv(J, rx) + mtv(C, y_bar)


def _mu(H: AlHessian) -> Tensor:
    return H.mu[:, None, None].to(H.J.dtype)


def gram_j(J: Tensor) -> Tensor:
    """The JᵀJ block of the Gram operator, (B, n, n).  Affine-residual
    problems (SolverOptions.linear_residuals) compute it once per solve and
    hand it to the builders' `Gj=` on every refresh."""
    return J.mT @ J


def with_gram(H: AlHessian, Gj: Optional[Tensor] = None) -> AlHessian:
    """Materialize G = JᵀJ + mu CᵀC (`Gj` skips the JᵀJ product)."""
    jtj = gram_j(H.J) if Gj is None else Gj.to(H.J.dtype)
    G = jtj if H.C.shape[-2] == 0 else jtj + _mu(H) * (H.C.mT @ H.C)
    return AlHessian(H.J, H.C, H.mu, G=G)


def _stacked(H: AlHessian) -> Tensor:
    """S = [J; sqrt(mu)·C], so that SᵀS = H."""
    if H.C.shape[-2] == 0:
        return H.J
    return torch.cat([H.J, torch.sqrt(_mu(H)) * H.C], dim=-2)


def with_r_factor(H: AlHessian) -> AlHessian:
    """Materialize R from a thin QR of S = [J; sqrt(mu)·C] (`ops/qr.qr_r`:
    the MGS kernel for few columns, Householder otherwise)."""
    from .qr import qr_r

    return AlHessian(H.J, H.C, H.mu, R=qr_r(_stacked(H)))


def with_r_factor_cholqr2(H: AlHessian, Gj: Optional[Tensor] = None) -> AlHessian:
    """Materialize R with RᵀR = JᵀJ + mu CᵀC by CholeskyQR2 with the
    implicit refinement pass from the formed Gram (`Gj` skips the JᵀJ
    product); a lane whose implicit refinement breaks down is rescued
    through the explicit pass on S = [J; sqrt(mu) C], that lane only."""
    from .qr import cholqr2i_r

    return AlHessian(H.J, H.C, H.mu, R=cholqr2i_r(_stacked(H), with_gram(H, Gj).G))


def hv(H: AlHessian, v: Tensor) -> Tensor:
    """H @ v: Rᵀ(Rv) or Gv when materialized, else Jᵀ(Jv) + mu Cᵀ(Cv)."""
    if H.R is not None:
        return mtv(H.R, mv(H.R, v))
    if H.G is not None:
        return mv(H.G, v)
    jv = mtv(H.J, mv(H.J, v))
    if H.C.shape[-2] == 0:
        return jv
    return jv + H.mu.unsqueeze(-1) * mtv(H.C, mv(H.C, v))


def vhv(H: AlHessian, v: Tensor) -> Tensor:
    """vᵀHv: ‖Rv‖² or vᵀGv when materialized, else ‖Jv‖² + mu ‖Cv‖²."""
    if H.R is not None:
        Rv = mv(H.R, v)
        return vdot(Rv, Rv)
    if H.G is not None:
        return vdot(v, mv(H.G, v))
    Jv = mv(H.J, v)
    Cv = mv(H.C, v)
    return vdot(Jv, Jv) + H.mu * vdot(Cv, Cv)


def new_point(x: Tensor, y: Tensor, mu: Tensor, fns) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, AlHessian]:
    """Full evaluation at x: (rx, cx, y_bar, mx, g, H).  `fns` holds the
    batched callables (`solver/api.NLSFunctions`)."""
    rx = fns.residuals(x)
    cx = fns.nlconstraints(x)
    Jx = fns.jac_res(x)
    Cx = fns.jac_nlcons(x)
    y_bar = y + mu.unsqueeze(-1) * cx
    mx = al_value(rx, cx, y, mu)
    g = al_gradient(Jx, Cx, rx, y_bar)
    return rx, cx, y_bar, mx, g, AlHessian(Jx, Cx, mu)


def evaluate_al(x: Tensor, y: Tensor, mu: Tensor, fns) -> Tuple[Tensor, Tensor, Tensor]:
    """Value-only evaluation (no Jacobians): (rx, cx, mx)."""
    rx = fns.residuals(x)
    cx = fns.nlconstraints(x)
    return rx, cx, al_value(rx, cx, y, mu)

