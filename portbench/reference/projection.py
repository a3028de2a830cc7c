"""Exact-projection criticality of many points at once, in plain PyTorch
float64: the reference's own reading of the certificate the solver under
test claims.

    pix(x) = ‖P_Ω(x − Jᵀr) − x‖₂,   Ω = {v : A v = b, xl ≤ v ≤ xu}

P_Ω is the algorithm of `numpy_solver.project_polyhedron_np` (a damped
semismooth Newton on the equality multipliers λ, with the exact line
search on the concave dual), written over a leading lane axis so that
every lane of a run is read, not a sample.  Each lane stops updating once
‖A v − b‖∞ ≤ tol, as the NumPy loop breaks.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _clip(z: Tensor, xl: Tensor, xu: Tensor) -> Tensor:
    return torch.minimum(torch.maximum(z, xl), xu)


def project_polyhedron(z: Tensor, A: Tensor, b: Tensor, xl: Tensor, xu: Tensor,
                       tol: float = 1e-12, max_iter: int = 100):
    """argmin ‖v − z‖ s.t. A v = b, xl ≤ v ≤ xu for each lane.

    z (N, n); A (m, n); b (N, m); xl, xu (n,).  Returns (v, the final
    ‖A v − b‖∞ of each lane)."""
    N, m = z.shape[0], A.shape[0]
    lam = z.new_zeros((N, m))
    running = torch.ones(N, dtype=torch.bool, device=z.device)
    reg = 1e-12 * torch.eye(m, dtype=z.dtype, device=z.device)
    for _ in range(max_iter):
        z0 = z - lam @ A
        v = _clip(z0, xl, xu)
        F = v @ A.T - b
        running &= F.abs().amax(-1) > tol
        if not bool(running.any()):
            break
        inside = ((z0 > xl) & (z0 < xu)).to(z.dtype)
        Jd = torch.einsum("in,kn,jn->kij", A, inside, A) + reg
        d = torch.linalg.solve(Jd, F.unsqueeze(-1)).squeeze(-1)
        w = d @ A
        db = (d * b).sum(-1)

        def phi(t: Tensor) -> Tensor:
            return (w * _clip(z0 - t[:, None] * w, xl, xu)).sum(-1) - db

        # Bracket the root of the non-increasing slope, then bisect.
        t_hi = torch.ones(N, dtype=z.dtype, device=z.device)
        for _ in range(60):
            grow = phi(t_hi) > 0.0
            if not bool(grow.any()):
                break
            t_hi = torch.where(grow, 2.0 * t_hi, t_hi)
        t_lo = torch.zeros_like(t_hi)
        for _ in range(80):
            t_mid = 0.5 * (t_lo + t_hi)
            up = phi(t_mid) > 0.0
            t_lo, t_hi = torch.where(up, t_mid, t_lo), torch.where(up, t_hi, t_mid)
        lam = torch.where(running[:, None], lam + (0.5 * (t_lo + t_hi))[:, None] * d, lam)
    v = _clip(z - lam @ A, xl, xu)
    return v, (v @ A.T - b).abs().amax(-1)


def criticality(x: Tensor, g: Tensor, A: Tensor, b: Tensor, xl: Tensor, xu: Tensor):
    """(pix, projection residual) of each lane: x, g (N, n) float64."""
    v, resid = project_polyhedron(x - g, A, b, xl, xu)
    return torch.linalg.vector_norm(v - x, dim=-1), resid
