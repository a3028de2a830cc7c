"""Problem-family generators (PyTorch port of `exp_fit_family`,
`sphere_family`, `dense_quadratic_family`, `ill_conditioned_family` and
`blocked_hard_family` in `benlsip_tpu/problems/generators.py`).

The data come from the same numpy recipe as the JAX generators, so theta,
the constraint data and X0 are bit-identical for the same arguments.  The
tensors are created on `device`; None is the CUDA card
(`_device.resolve_device`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
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

    kw = {"dtype": dtype, "device": resolve_device(device)}
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


def _sphere_residuals(x: Tensor, th: dict) -> Tensor:
    base = torch.stack(
        [
            x[0] ** 2 + x[1] ** 2 - 2 * x[0] + torch.sin(x[0] + x[1]) - 1.5,
            x[0] * x[1] + 0.5 * torch.cos(2 * x[0]) - 0.8,
            (x[0] - 1.0) ** 2 + (x[1] - 0.5) ** 2 - x[2],
            x[2] ** 2 - x[0] + 0.3 * torch.sin(x[2]) - 0.2,
        ]
    )
    return base + th["off"]


def _sphere_nlconstraints(x: Tensor, th: dict) -> Tensor:
    return torch.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - th["rad"]])


def sphere_family(
    B: int, seed: int = 0, dtype: torch.dtype = torch.float64, device=None,
) -> Tuple[BatchedProblem, dict, Tensor]:
    """Batched perturbations of the sphere-regression fixture
    (`problems/sphere_regression.py`): per-instance shifts of the residual
    offsets and the sphere radius.  Shapes n=3, d=4, p=1, m=1; the
    Jacobians come from autodiff.  Returns (BatchedProblem, theta, X0) on
    `device`.
    """
    rng = np.random.default_rng(seed)
    kw = {"dtype": dtype, "device": resolve_device(device)}
    theta = {
        "off": torch.as_tensor(rng.uniform(-0.1, 0.1, (B, 4)), **kw),
        "rad": torch.as_tensor(3.0 + rng.uniform(-0.2, 0.2, B), **kw),
    }
    bp = BatchedProblem(
        residuals=_sphere_residuals,
        nlconstraints=_sphere_nlconstraints,
        A=torch.as_tensor([[1.0, 2.0, -1.0]], **kw),
        b=torch.as_tensor([0.5], **kw),
        xl=torch.as_tensor([-2.0, -1.5, 0.0], **kw),
        xu=torch.as_tensor([2.0, 1.5, 2.0], **kw),
    )
    X0 = torch.as_tensor([1.0, 0.5, 1.5], **kw).expand(B, 3).contiguous()
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

    kw = {"dtype": dtype, "device": resolve_device(device)}
    bp = _shared_linear_problem(J, A, b, 0.8, kw)
    # Feasible start: zero projected onto {Ax = b} (bounds hold at 0).
    x0 = np.clip(A.T @ np.linalg.solve(A @ A.T, b), -0.79, 0.79)
    X0 = torch.as_tensor(np.broadcast_to(x0, (B, n)).copy(), **kw)
    return bp, {"y": torch.as_tensor(y, **kw)}, X0


def ill_conditioned_family(
    B: int,
    n: int = 96,
    d: int = 384,
    m: int = 3,
    kappa: float = 1e4,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[BatchedProblem, dict, Tensor]:
    """Config-3 shape with a controlled Jacobian condition number: J has
    singular values kappa^(-i/(n-1)), i = 0..n-1, so that forming JᵀJ in
    float32 rounds away everything below kappa²·eps (no signal left at
    kappa ≳ 3e3) where a QR route keeps kappa·eps.  Consistent targets
    (y = J x_true + 1e-6 noise), shared equalities A x = b, box bounds ±3.
    Returns (BatchedProblem, theta, X0) on `device`.
    """
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((d, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sv = kappa ** (-np.arange(n) / (n - 1))
    J = (U * sv[None, :]) @ V.T
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = rng.standard_normal((B, n))
    y = x_true @ J.T + 1e-6 * rng.standard_normal((B, d))
    b = x_true[0] @ A.T

    kw = {"dtype": dtype, "device": resolve_device(device)}
    bp = _shared_linear_problem(J, A, b, 3.0, kw)
    x0 = np.clip(A.T @ np.linalg.solve(A @ A.T, b), -2.9, 2.9)
    X0 = torch.as_tensor(np.broadcast_to(x0, (B, n)).copy(), **kw)
    return bp, {"y": torch.as_tensor(y, **kw)}, X0


def blocked_hard_family(
    n: int = 10240,
    d: int = 20480,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    alpha: float = 1.5,
    m: int = 8,
    bound: float = 0.8,
    spread: float = 1.6,
    noise: float = 1e-2,
    device=None,
) -> Tuple[BatchedProblem, dict, Tensor]:
    """One large nonlinear bound-active instance (BASELINE config 4) for the
    blocked-Jacobian path (`dist/sharded.solve_large_blocked_family`):

        r(x) = J0 psi(x) - y,   psi(x) = x + alpha x³ (elementwise),
        J(x) = J0 · psi'(x) column-scaled, psi' = 1 + 3 alpha x².

    x_true ~ U(-spread, spread) with spread > bound, so about half of the
    coordinates are active at the solution; a linear equality block Ax = b
    (b = A clip(x_true), feasible with the box) keeps the constraint stack
    live.  Returns (bp, theta, x0) with theta = {"J": (d, n), "y": (d,)}
    and x0 (n,), the min-norm feasible point of Ax = b, clipped; one
    instance, so theta carries no batch axis (the solver adds it as a
    view).  The numpy recipe is the JAX generator's, so every array is
    bit-identical to its.
    """
    rng = np.random.default_rng(seed)
    J0 = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    x_true = rng.uniform(-spread, spread, n).astype(np.float32)
    psi_true = x_true + alpha * x_true**3
    y = J0 @ psi_true + noise * rng.standard_normal(d).astype(np.float32)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    b = A @ np.clip(x_true, -bound, bound)

    kw = {"dtype": dtype, "device": resolve_device(device)}
    theta = {"J": torch.as_tensor(J0, **kw), "y": torch.as_tensor(y, **kw)}

    def residuals(x, th):
        return th["J"] @ (x + alpha * x**3) - th["y"]

    def jac_res(x, th):
        return th["J"] * (1.0 + 3.0 * alpha * x**2)

    bp = BatchedProblem(
        residuals=residuals,
        jac_res=jac_res,
        A=torch.as_tensor(A, **kw),
        b=torch.as_tensor(b, **kw),
        xl=torch.full((n,), -bound, **kw),
        xu=torch.full((n,), bound, **kw),
    )
    x0 = np.clip(A.T @ np.linalg.solve(A @ A.T, b), -bound, bound)
    return bp, theta, torch.as_tensor(x0, **kw)
