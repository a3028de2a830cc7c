"""Masked tangent-space projections (PyTorch port of `benlsip_tpu/ops/project.py`).

P r = Z r - Z Aᵀ (A Z Aᵀ)⁻¹ A Z r,  Z = diag(¬fixed): zero the fixed
coordinates, one small Cholesky solve, one matvec pair — the
per-CG-iteration hot path, one launch of the fused projection kernel for
float32 (`ops/cholesky.masked_projection`).
"""
from __future__ import annotations

import torch

from .._batched import norm
from .cholesky import masked_projection
from .constraints import ActiveSet, Polyhedron

Tensor = torch.Tensor


def project_tangent(poly: Polyhedron, aset: ActiveSet, r: Tensor) -> Tensor:
    """Orthogonal projection of r onto {v : Av = 0, v_i = 0 for i fixed}."""
    if poly.A.shape[-2] == 0:
        return torch.where(aset.fixed, 0.0, r)
    return masked_projection(poly.A, aset.chol, aset.fixed, r)


def norm_reduced_gradient(poly: Polyhedron, aset: ActiveSet, g: Tensor) -> Tensor:
    """‖P(-g)‖ per lane — the reduced-gradient criticality measure."""
    return norm(project_tangent(poly, aset, -g))
