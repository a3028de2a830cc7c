"""Hock–Schittkowski problem 48 as a constrained NLS instance (PyTorch port
of `benlsip_tpu/problems/hs48.py`).

min ‖r(x)‖² with r = (x₁-1, x₂-x₃, x₄-x₅) subject to Σx = 5 and
x₃ - 2(x₄+x₅) = -3.  Optimum at (1,1,1,1,1) with objective 0.
"""
from __future__ import annotations

import torch

from .._device import as_tensor
from ..solver.api import Problem

A = [[1.0, 1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 1.0, -2.0, -2.0]]
b = [5.0, -3.0]


def residuals(x):
    return torch.stack([x[0] - 1.0, x[1] - x[2], x[3] - x[4]])


def make_problem() -> Problem:
    return Problem(residuals=residuals, A=A, b=b)


def x0(dtype: torch.dtype = torch.float64, device=None):
    """The classical HS48 start (3, 5, -3, 2, -2), on `device` (None: the CUDA card)."""
    return as_tensor([3.0, 5.0, -3.0, 2.0, -2.0], dtype, device)


def x_star(dtype: torch.dtype = torch.float64, device=None):
    return as_tensor([1.0] * 5, dtype, device)
