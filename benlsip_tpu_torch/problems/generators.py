"""Problem-family generators (PyTorch port of `exp_fit_family` and
`dense_quadratic_family` in `benlsip_tpu/problems/generators.py`).

The data come from the same numpy recipe as the JAX generators, so theta,
the constraint data and X0 are bit-identical for the same arguments.
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


def _shared_linear_problem(J: np.ndarray, A: np.ndarray, b: np.ndarray, bound: float, kw: dict) -> BatchedProblem:
    """r(x) = J x - y with J shared by every instance.

    J is closed over, not per-instance theta, and cast to the working
    dtype and device inside the callables, so the f32 bulk and the f64
    certification (on the card or the CPU) evaluate the same master data;
    each cast is made once per (device, dtype) and kept.  Under
    `torch.func.vmap` the Jacobian comes back as a stride-0 expand of J,
    (B, d, n) without a copy.
    """
    Jt = torch.as_tensor(J, **kw)
    casts = {(Jt.device, Jt.dtype): Jt}

    def jac_res(x, th):
        key = (x.device, x.dtype)
        if key not in casts:
            casts[key] = Jt.to(device=x.device, dtype=x.dtype)
        return casts[key]

    def residuals(x, th):
        return jac_res(x, th) @ x - th["y"]

    n = J.shape[1]
    return BatchedProblem(
        residuals=residuals,
        jac_res=jac_res,
        A=torch.as_tensor(A, **kw),
        b=torch.as_tensor(b, **kw),
        xl=torch.full((n,), -bound, **kw),
        xu=torch.full((n,), bound, **kw),
    )


def dense_quadratic_family(
    B: int,
    n: int = 64,
    d: int = 256,
    m: int = 4,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[BatchedProblem, dict, Tensor]:
    """Medium dense linear least squares with polyhedral constraints
    (BASELINE config 3 shape): r(x) = J x - y with a shared random J,
    per-instance targets, shared linear equalities Ax = b and box bounds
    ±0.8 that bind for ~20% of the coordinates.  Returns
    (BatchedProblem, theta, X0) on `device`.
    """
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((d, n)) / np.sqrt(d)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = rng.standard_normal((B, n))
    y = x_true @ J.T + 0.01 * rng.standard_normal((B, d))
    b = x_true[0] @ A.T   # shared rhs: every instance projects onto the same plane

    kw = {"dtype": dtype, "device": device}
    bp = _shared_linear_problem(J, A, b, 0.8, kw)
    # Feasible start: zero projected onto {Ax = b} (bounds hold at 0).
    x0 = np.clip(A.T @ np.linalg.solve(A @ A.T, b), -0.79, 0.79)
    X0 = torch.as_tensor(np.broadcast_to(x0, (B, n)).copy(), **kw)
    return bp, {"y": torch.as_tensor(y, **kw)}, X0
