"""Masked tangent-space projections (PyTorch port of `benlsip_tpu/ops/project.py`).

P r = Z r - Z Aᵀ (A Z Aᵀ)⁻¹ A Z r,  Z = diag(¬fixed): zero the fixed
coordinates, one small Cholesky solve (the kernel, for float32), one
matvec pair — the per-CG-iteration hot path.
"""
from __future__ import annotations

import torch

from .._batched import mtv, mv, norm
from .cholesky import cho_solve_lower
from .constraints import ActiveSet, Polyhedron

Tensor = torch.Tensor


def project_tangent(poly: Polyhedron, aset: ActiveSet, r: Tensor) -> Tensor:
    """Orthogonal projection of r onto {v : Av = 0, v_i = 0 for i fixed}."""
    free = ~aset.fixed
    rz = torch.where(free, r, 0.0)
    if poly.A.shape[-2] == 0:
        return rz
    w = cho_solve_lower(aset.chol, mv(poly.A, rz))
    return rz - torch.where(free, mtv(poly.A, w), 0.0)


def norm_reduced_gradient(poly: Polyhedron, aset: ActiveSet, g: Tensor) -> Tensor:
    """‖P(-g)‖ per lane — the reduced-gradient criticality measure."""
    return norm(project_tangent(poly, aset, -g))
