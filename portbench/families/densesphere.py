"""Dense linear least squares under a norm constraint (LSQI, Gander 1981),
with the shared equalities and the box of BASELINE config 3:
r(x) = J x − y, c(x) = xᵀx − ρ² (p = 1), A x = b, and the box ±bound —
BEnlsip.jl's `test/problems/sphere_regression.jl` constraint structure
(one sphere beside linear equalities and a box) at config 3's widths.

J, A, the true coefficients, the targets y and b are drawn exactly as
`densequad` draws them, from the configuration's `data_seed` and in the
same order, so the instances are densequad's with the sphere added.  Each
lane's radius is then ρ = radius_factor·‖clip(x_true, ±bound)‖₂, a
fixed share of the norm of the clipped coefficients it was made from, so
the sphere binds with a positive multiplier.  ρ² is per-lane theta, and
c, its Jacobian 2xᵀ and the polish's curvature term 2y·I (the residuals
are linear, so only the sphere's Hessian is left) are written by hand.
The run's seed shuffles the lanes of each batch, y and ρ² together.
Start ("cold"): densequad's, zero projected onto A x = b, clipped to
±start_clip.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem

from .densequad import shared_linear_problem
from .expfit import shuffle_lanes

# The family hands the port the curvature of its sphere; a port whose
# problems take no such callable cannot run it, and says so on import,
# before any set-up.
if "lagrangian_curvature" not in {f.name for f in dataclasses.fields(BatchedProblem)}:
    raise ImportError("densesphere: this port's BatchedProblem takes no lagrangian_curvature")


def nlconstraints(x, th):
    return (x @ x - th["rho2"]).reshape(1)


def jac_nlcons(x, th):
    return 2.0 * x.unsqueeze(0)


def lagrangian_curvature(x, y, th):
    """Σⱼ rⱼ∇²rⱼ + y∇²c = 2y·I: the residuals are linear."""
    return torch.diag_embed((2.0 * y[0]).expand(x.shape))


class Pool:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        if mix["start"] != "cold":
            raise ValueError(f"densesphere: unknown start {mix['start']!r}")
        gen = torch.Generator(device=device).manual_seed(cfg["data_seed"])
        P, B, n, d, m = mix["pool"], mix["batch"], cfg["n"], cfg["d"], cfg["m"]
        kw = {"dtype": torch.float64, "device": device}
        self.J = torch.randn((d, n), generator=gen, **kw) / math.sqrt(d)
        self.A = torch.randn((m, n), generator=gen, **kw) / math.sqrt(n)
        x_true = torch.randn((P, B, n), generator=gen, **kw)
        y = x_true @ self.J.T + cfg["noise"] * torch.randn((P, B, d), generator=gen, **kw)
        rho = cfg["radius_factor"] * torch.linalg.vector_norm(x_true.clamp(-cfg["bound"], cfg["bound"]), dim=-1)
        order = shuffle_lanes(P, B, seed, device)
        self.y = y.gather(1, order[..., None].expand(P, B, d))
        self.rho2 = (rho * rho).gather(1, order)[..., None].contiguous()       # (P, B, 1)
        self.b = self.A @ x_true[0, 0]            # shared: every instance projects onto one plane
        self.bp = dataclasses.replace(shared_linear_problem(self.J, self.A, self.b, cfg["bound"]),
                                      nlconstraints=nlconstraints, jac_nlcons=jac_nlcons,
                                      lagrangian_curvature=lagrangian_curvature)
        x0 = self.A.T @ torch.linalg.solve(self.A @ self.A.T, self.b)
        self.X0 = x0.clamp(-cfg["start_clip"], cfg["start_clip"]).expand(B, n).contiguous()
        self.size = P

    def batch(self, k: int):
        return self.bp, {"y": self.y[k], "rho2": self.rho2[k]}, self.X0

    def inputs(self, k: int):
        return ({"y": self.y[k], "rho2": self.rho2[k]},
                {"J": self.J, "A": self.A, "b": self.b, "xl": self.bp.xl, "xu": self.bp.xu})

    def start(self, k: int) -> torch.Tensor:
        return self.X0
