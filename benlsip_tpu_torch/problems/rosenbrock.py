"""Bound-constrained Rosenbrock NLS (PyTorch port of
`benlsip_tpu/problems/rosenbrock.py`; BASELINE config 1's example problem).

Residual form r(x) = (10(x₂-x₁²), 1-x₁) with optional box; the classic
n=2/d=2 curved-valley test.  The chained n-dimensional variant gives a
size-scalable single-instance family.
"""
from __future__ import annotations

import torch

from .._device import as_tensor
from ..solver.api import Problem


def residuals2(x):
    return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def make_problem(bounded: bool = True) -> Problem:
    """2-D Rosenbrock NLS; bounded=True adds the box [-0.5, 1.5]² whose
    lower edge x₁ ≥ -0.5 is inactive at the solution (1, 1) but shapes the
    iteration path."""
    return Problem(
        residuals=residuals2,
        xl=[-0.5, -0.5] if bounded else None,
        xu=[1.5, 1.5] if bounded else None,
    )


def make_chained(n: int) -> Problem:
    """Chained Rosenbrock: d = 2(n-1) residuals, solution at ones(n)."""

    def residuals(x):
        return torch.cat([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])

    return Problem(residuals=residuals, xl=[-2.0] * n, xu=[2.0] * n)


def x0(dtype: torch.dtype = torch.float64, device=None):
    """The classical start (-1.2, 1), on `device` (None: the CUDA card)."""
    return as_tensor([-1.2, 1.0], dtype, device)
