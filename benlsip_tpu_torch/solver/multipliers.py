"""Lagrange multiplier estimates (PyTorch port of `benlsip_tpu/solver/multipliers.py`).

p == 0 (no nonlinear constraints) returns an empty (B, 0) multiplier.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._batched import mtv, mv
from ..ops.al import _psum
from ..ops.cholesky import chol_linalg, cho_solve_lower, solve_triangular

Tensor = torch.Tensor


def least_squares_multipliers(x: Tensor, fns, method: str = "qr", axis: Optional[str] = None) -> Tensor:
    """y = argmin_y ‖Cᵀ y + Jᵀ r‖ per lane.

    method="normal": Cholesky of CCᵀ (the reference's algebra);
    method="qr": thin QR of Cᵀ (through the QR kernel gate) and a
    triangular solve — the same solution, κ(C)-accurate (bf16: the kernel's
    QR, the solve in float32 rounded back).  Under `axis` J and r hold this
    rank's rows and Jᵀr is summed over it.
    """
    C = fns.jac_nlcons(x)
    B, p, _ = C.shape
    if p == 0:
        return torch.zeros((B, 0), dtype=x.dtype, device=x.device)
    g = _psum(mtv(fns.jac_res(x), fns.residuals(x)), axis)
    if method == "normal":
        L = chol_linalg(C @ C.mT)
        return cho_solve_lower(L, -mv(C, g))
    from ..ops.qr import thin_qr

    Q, R = thin_qr(C.mT)
    rhs = -mtv(Q, g)
    return solve_triangular(R, rhs.unsqueeze(-1), upper=True).squeeze(-1)


def first_order_multipliers(y: Tensor, cx: Tensor, mu: Tensor) -> Tensor:
    """The first-order update y ← y + mu·c, per lane (mu (B,))."""
    return y + mu.unsqueeze(-1) * cx
