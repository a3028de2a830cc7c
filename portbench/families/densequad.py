"""Dense linear least squares with polyhedral constraints (BASELINE
config 3): r(x) = J x − y with one J shared by every instance, shared
equalities A x = b, and the box ±bound.

The benchmark's own copy of the arithmetic of the port's
`problems/generators.dense_quadratic_family`, made on the device by a
`torch.Generator` in a few large calls.  The instances come from the
configuration's `data_seed`, so that every run carries the same work; the
run's seed shuffles the lanes of each batch.  The pool varies the targets
y under one problem (one J, one closure), so the port's graph cache key
stays put from batch to batch.  Start ("cold"): zero projected
onto A x = b, clipped to ±start_clip.
"""
from __future__ import annotations

import math

import torch

from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem

from .expfit import shuffle_lanes


def shared_linear_problem(J: torch.Tensor, A: torch.Tensor, b: torch.Tensor, bound: float) -> BatchedProblem:
    """r(x) = J x − y with J closed over; J is cast to x's device and
    dtype inside the callables, once per (device, dtype)."""
    casts = {(J.device, J.dtype): J}

    def jac_res(x, th):
        key = (x.device, x.dtype)
        if key not in casts:
            casts[key] = J.to(device=x.device, dtype=x.dtype)
        return casts[key]

    def residuals(x, th):
        return jac_res(x, th) @ x - th["y"]

    n = J.shape[1]
    return BatchedProblem(residuals=residuals, jac_res=jac_res, A=A, b=b,
                          xl=torch.full((n,), -bound, dtype=J.dtype, device=J.device),
                          xu=torch.full((n,), bound, dtype=J.dtype, device=J.device))


class Pool:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        if mix["start"] != "cold":
            raise ValueError(f"densequad: unknown start {mix['start']!r}")
        gen = torch.Generator(device=device).manual_seed(cfg["data_seed"])
        P, B, n, d, m = mix["pool"], mix["batch"], cfg["n"], cfg["d"], cfg["m"]
        kw = {"dtype": torch.float64, "device": device}
        self.J = torch.randn((d, n), generator=gen, **kw) / math.sqrt(d)
        self.A = torch.randn((m, n), generator=gen, **kw) / math.sqrt(n)
        x_true = torch.randn((P, B, n), generator=gen, **kw)
        y = x_true @ self.J.T + cfg["noise"] * torch.randn((P, B, d), generator=gen, **kw)
        self.y = y.gather(1, shuffle_lanes(P, B, seed, device)[..., None].expand(P, B, d))
        self.b = self.A @ x_true[0, 0]            # shared: every instance projects onto one plane
        self.bp = shared_linear_problem(self.J, self.A, self.b, cfg["bound"])
        x0 = self.A.T @ torch.linalg.solve(self.A @ self.A.T, self.b)
        self.X0 = x0.clamp(-cfg["start_clip"], cfg["start_clip"]).expand(B, n).contiguous()
        self.size = P

    def batch(self, k: int):
        return self.bp, {"y": self.y[k]}, self.X0

    def inputs(self, k: int):
        return {"y": self.y[k]}, {"J": self.J, "A": self.A, "b": self.b, "xl": self.bp.xl, "xu": self.bp.xu}

    def start(self, k: int) -> torch.Tensor:
        return self.X0
