"""Problem-family generators (PyTorch port of `exp_fit_family` in
`benlsip_tpu/problems/generators.py`).

The data come from the same numpy recipe as the JAX generator, so theta,
the constraint data and X0 are bit-identical for the same (B, d, seed).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..batch.vmap_solve import BatchedProblem

Tensor = torch.Tensor


def _exp_fit_residuals(x: Tensor, th: dict) -> Tensor:
    return x[0] * torch.exp(-x[1] * th["t"]) + x[2] - th["y"]


def exp_fit_family(
    B: int,
    d: int = 32,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    with_constraints: bool = True,
    device=None,
) -> Tuple[BatchedProblem, dict, Tensor]:
    """Batched exponential curve fitting (BASELINE config 2 workload).

    Per instance: fit y_j ≈ a·exp(-b t_j) + c over d samples; x = (a, b, c)
    with bounds 0.05 ≤ b ≤ 5, -10 ≤ a, c ≤ 10, and (optionally) the linear
    equality a + c = y(0).  Returns (BatchedProblem, theta, X0) on `device`.
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 3.0, d)
    a = rng.uniform(0.5, 3.0, B)
    bb = rng.uniform(0.3, 2.0, B)
    c = rng.uniform(-1.0, 1.0, B)
    y = a[:, None] * np.exp(-bb[:, None] * t[None, :]) + c[:, None]
    y += 0.01 * rng.standard_normal((B, d))

    kw = {"dtype": dtype, "device": device}
    theta = {
        "t": torch.as_tensor(np.ascontiguousarray(np.broadcast_to(t, (B, d))), **kw),
        "y": torch.as_tensor(y, **kw),
    }
    A = b_rhs = None
    if with_constraints:
        A = torch.as_tensor([[1.0, 0.0, 1.0]], **kw)
        b_rhs = torch.as_tensor(np.ascontiguousarray(y[:, :1]), **kw)  # (B, 1)
    bp = BatchedProblem(
        residuals=_exp_fit_residuals,
        A=A,
        b=b_rhs,
        xl=torch.as_tensor([-10.0, 0.05, -10.0], **kw),
        xu=torch.as_tensor([10.0, 5.0, 10.0], **kw),
        poly_batched=with_constraints,
    )
    X0 = torch.as_tensor(np.stack([np.ones(B), np.full(B, 1.0), np.zeros(B)], axis=1), **kw)
    if with_constraints:
        X0[:, 2] = theta["y"][:, 0] - X0[:, 0]   # start feasible w.r.t. a + c = y0
    return bp, theta, X0
