"""Masked tangent-space projections (PyTorch port of `benlsip_tpu/ops/project.py`).

P r = Z r - Z Aᵀ (A Z Aᵀ)⁻¹ A Z r,  Z = diag(¬fixed): zero the fixed
coordinates, one small Cholesky solve, one matvec pair — the
per-CG-iteration hot path, one launch of the fused projection kernel for
float32 (`ops/cholesky.masked_projection`).  `left_mul` / `left_mul_tr`
are the masked fixed-shape products with Ã = [A; e_iᵀ for i fixed].
"""
from __future__ import annotations

import torch

from .._batched import mtv, mv, norm
from .cholesky import masked_projection
from .constraints import ActiveSet, Polyhedron

Tensor = torch.Tensor


def left_mul(poly: Polyhedron, fixed: Tensor, x: Tensor) -> Tensor:
    """Ã x as (B, m + n): [A x ; where(fixed, x, 0)] (the inactive bound
    slots hold zeros, so the shape does not depend on the mask)."""
    return torch.cat([mv(poly.A, x), torch.where(fixed, x, 0)], dim=-1)


def left_mul_tr(poly: Polyhedron, fixed: Tensor, y: Tensor) -> Tensor:
    """Ãᵀ y for y = [y_lin (B, m) ; y_bnd (B, n)] in `left_mul`'s layout."""
    m = poly.A.shape[-2]
    return mtv(poly.A, y[..., :m]) + torch.where(fixed, y[..., m:], 0)


def project_tangent(poly: Polyhedron, aset: ActiveSet, r: Tensor) -> Tensor:
    """Orthogonal projection of r onto {v : Av = 0, v_i = 0 for i fixed}."""
    if poly.A.shape[-2] == 0:
        return torch.where(aset.fixed, 0.0, r)
    return masked_projection(poly.A, aset.chol, aset.fixed, r)


def norm_reduced_gradient(poly: Polyhedron, aset: ActiveSet, g: Tensor) -> Tensor:
    """‖P(-g)‖ per lane — the reduced-gradient criticality measure."""
    return norm(project_tangent(poly, aset, -g))
