"""Augmented-Lagrangian evaluation and the matrix-free Gauss-Newton Hessian
(PyTorch port of the matrix-free half of `benlsip_tpu/ops/al.py`).

* m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc
* g(x) = Jᵀr + Cᵀ(y + mu c)
* H    = JᵀJ + mu CᵀC, held as the triple (J, C, mu), never materialized.

The materialized operators of the JAX module (Gram matrix, QR and
CholeskyQR2 factors, row-sharded layouts) are not ported yet: the solver
only builds them for n ≥ 64 (`solver/subproblem.resolve_operator_route`).
p == 0 (no nonlinear constraints) is carried as a zero-row C.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .._batched import mtv, mv, vdot

Tensor = torch.Tensor


class AlHessian(NamedTuple):
    """Matrix-free Gauss-Newton Hessian H = JᵀJ + mu CᵀC, batched."""

    J: Tensor   # (B, d, n)
    C: Tensor   # (B, p, n), p may be 0
    mu: Tensor  # (B,)


def al_value(rx: Tensor, cx: Tensor, y: Tensor, mu: Tensor) -> Tensor:
    """m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc per lane."""
    return 0.5 * vdot(rx, rx) + vdot(y, cx) + 0.5 * mu * vdot(cx, cx)


def al_gradient(J: Tensor, C: Tensor, rx: Tensor, y_bar: Tensor) -> Tensor:
    """g = Jᵀ rx + Cᵀ y_bar with y_bar = y + mu c."""
    return mtv(J, rx) + mtv(C, y_bar)


def hv(H: AlHessian, v: Tensor) -> Tensor:
    """H @ v = Jᵀ(Jv) + mu Cᵀ(Cv)."""
    jv = mtv(H.J, mv(H.J, v))
    if H.C.shape[-2] == 0:
        return jv
    return jv + H.mu.unsqueeze(-1) * mtv(H.C, mv(H.C, v))


def vhv(H: AlHessian, v: Tensor) -> Tensor:
    """vᵀHv = ‖Jv‖² + mu ‖Cv‖²."""
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

