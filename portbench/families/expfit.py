"""Exponential fits (BASELINE config 2): y_j ≈ a·exp(−b t_j) + c over d
samples, x = (a, b, c) in a box, with the per-lane equality a + c = y(0).

The benchmark's own copy of the arithmetic of the port's
`problems/generators.exp_fit_family`, made on the device by a
`torch.Generator` in a few large calls.  The instances come from the
configuration's `data_seed`, so that every run carries the same work; the
run's seed shuffles the lanes of each batch (which lanes share a bulk
chunk, and where each sits).  Starts (`mix["start"]`):

* "cold": the generator's start, a = 1, b = 1, c = y(0) − 1;
* "refit": a stream of drifting curves.  Frame k's parameters are frame
  k − 1's times (1 + U(−drift, drift)) per coordinate, and its start is
  frame k − 1's parameters clipped into the box, with c = y_k(0) − a.
"""
from __future__ import annotations

import torch

from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem


def shuffle_lanes(P: int, B: int, seed: int, device: torch.device) -> torch.Tensor:
    """(P, B) int64: a permutation of the B lanes of each batch, from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.argsort(torch.rand((P, B), generator=gen, device=device), dim=1)


def residuals(x, th):
    return x[0] * torch.exp(-x[1] * th["t"]) + x[2] - th["y"]


class Pool:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        gen = torch.Generator(device=device).manual_seed(cfg["data_seed"])
        P, B, d = mix["pool"], mix["batch"], cfg["d"]
        kw = {"dtype": torch.float64, "device": device}
        lo = torch.tensor([cfg["a_range"][0], cfg["b_range"][0], cfg["c_range"][0]], **kw)[:, None]
        hi = torch.tensor([cfg["a_range"][1], cfg["b_range"][1], cfg["c_range"][1]], **kw)[:, None]
        self.xl, self.xu = torch.tensor(cfg["xl"], **kw), torch.tensor(cfg["xu"], **kw)
        self.A = torch.tensor(cfg["A"], **kw)
        t = torch.linspace(0.0, cfg["t_max"], d, **kw)
        if mix["start"] == "cold":
            params = lo + (hi - lo) * torch.rand((P, 3, B), generator=gen, **kw)       # (P, 3, B)
        elif mix["start"] == "refit":
            base = lo + (hi - lo) * torch.rand((3, B), generator=gen, **kw)
            drift = 1.0 + mix["drift"] * (2.0 * torch.rand((P, 3, B), generator=gen, **kw) - 1.0)
            params = base * torch.cumprod(drift, dim=0)
            prev = torch.cat([base[None], params[:-1]])
        else:
            raise ValueError(f"expfit: unknown start {mix['start']!r}")
        a, b, c = (params[:, i, :, None] for i in range(3))                          # (P, B, 1)
        y = a * torch.exp(-b * t) + c + cfg["noise"] * torch.randn((P, B, d), generator=gen, **kw)
        if mix["start"] == "cold":
            X0 = torch.stack([torch.ones_like(y[:, :, 0]), torch.ones_like(y[:, :, 0]), y[:, :, 0] - 1.0], dim=-1)
        else:
            X0 = torch.maximum(torch.minimum(prev.transpose(1, 2), self.xu), self.xl)
            X0[:, :, 2] = y[:, :, 0] - X0[:, :, 0]
        order = shuffle_lanes(P, B, seed, device)
        self.t = t.expand(B, d).contiguous()
        self.y = y.gather(1, order[..., None].expand(P, B, d))
        self.b = self.y[:, :, :1].contiguous()                                     # a + c = y(0)
        self.X0 = X0.gather(1, order[..., None].expand(P, B, 3)).contiguous()      # (P, B, 3)
        self.problems = [BatchedProblem(residuals=residuals, A=self.A, b=self.b[k], xl=self.xl, xu=self.xu,
                                        poly_batched=True) for k in range(P)]
        self.size = P

    def batch(self, k: int):
        return self.problems[k], {"t": self.t, "y": self.y[k]}, self.X0[k]

    def inputs(self, k: int):
        return {"t": self.t, "y": self.y[k], "b": self.b[k]}, {"A": self.A, "xl": self.xl, "xu": self.xu}

    def start(self, k: int) -> torch.Tensor:
        return self.X0[k]
