"""Sphere-regression integration test problem (PyTorch port of
`benlsip_tpu/problems/sphere_regression.py`).

The reference's end-to-end fixture: 3 parameters, 4 residuals, 1 nonlinear
equality constraint (sphere of radius sqrt(3)), 1 linear equality
constraint, full box bounds.  The callables are per-instance functions of
x (3,); the constraint data are plain lists here, and `make_problem` hands
them to the `Problem` as tensors of its `dtype` on the CPU, which
`Problem.build` casts to the solve's dtype and device.
"""
from __future__ import annotations

import torch

from .._device import as_tensor
from ..solver.api import Problem


def residuals(x):
    return torch.stack(
        [
            x[0] ** 2 + x[1] ** 2 - 2 * x[0] + torch.sin(x[0] + x[1]) - 1.5,
            x[0] * x[1] + 0.5 * torch.cos(2 * x[0]) - 0.8,
            (x[0] - 1.0) ** 2 + (x[1] - 0.5) ** 2 - x[2],
            x[2] ** 2 - x[0] + 0.3 * torch.sin(x[2]) - 0.2,
        ]
    )


def jac_res(x):
    """Analytic Jacobian (4, 3)."""
    z, one = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack(
        [
            torch.stack([2 * x[0] - 2 + torch.cos(x[0] + x[1]), 2 * x[1] + torch.cos(x[0] + x[1]), z]),
            torch.stack([x[1] - torch.sin(2 * x[0]), x[0], z]),
            torch.stack([2 * (x[0] - 1), 2 * (x[1] - 0.5), -one]),
            torch.stack([-one, z, 2 * x[2] + 0.3 * torch.cos(x[2])]),
        ]
    )


def nlconstraints(x):
    return torch.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 3.0])


def jac_nlcons(x):
    return torch.stack([torch.stack([2 * x[0], 2 * x[1], 2 * x[2]])])


A = [[1.0, 2.0, -1.0]]
b = [0.5]
xl = [-2.0, -1.5, 0.0]
xu = [2.0, 1.5, 2.0]


def make_problem(dtype: torch.dtype = torch.float64, analytic_jacobians: bool = True) -> Problem:
    """The fixture with its constraint data as `dtype` tensors on the CPU."""
    data = lambda a: torch.tensor(a, dtype=dtype)
    return Problem(
        residuals=residuals,
        nlconstraints=nlconstraints,
        jac_res=jac_res if analytic_jacobians else None,
        jac_nlcons=jac_nlcons if analytic_jacobians else None,
        A=data(A), b=data(b), xl=data(xl), xu=data(xu),
    )


def x0(dtype: torch.dtype = torch.float64, device=None):
    """Reference starting point, on `device` (None: the CUDA card)."""
    return as_tensor([1.0, 0.5, 1.5], dtype, device)
