"""Carry problem data and results between the JAX package and the port.

The two packages meet only through numpy arrays: the JAX side hands its
problem data over as numpy, these helpers turn them into the port's
tensors, and `info_to_numpy` turns the port's results back for the
comparison.  Residual callables cannot cross; the caller supplies the
port's torch residual (a per-instance function of (x, theta_i)).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ._device import resolve_device
from .batch.vmap_solve import BatchedProblem
from .solver.outer import SolveInfo


def _t(a, device=None, dtype: torch.dtype = torch.float64):
    return None if a is None else torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))


def problem_from_numpy(
    A: Optional[np.ndarray],
    b: Optional[np.ndarray],
    xl: Optional[np.ndarray],
    xu: Optional[np.ndarray],
    poly_batched: bool,
    residuals: Callable,
    device=None,
) -> BatchedProblem:
    """A float64 BatchedProblem on `device` (None: the CUDA card) from
    numpy constraint data and a per-instance torch residual of (x, theta_i)."""
    return BatchedProblem(
        residuals=residuals, A=_t(A, device), b=_t(b, device), xl=_t(xl, device), xu=_t(xu, device),
        poly_batched=poly_batched,
    )


def theta_from_numpy(theta_np, device=None, dtype: torch.dtype = torch.float64):
    """Problem data theta (a numpy array or a dict of them) as tensors on
    `device` (None: the CUDA card)."""
    if isinstance(theta_np, dict):
        return {k: theta_from_numpy(v, device, dtype) for k, v in theta_np.items()}
    return _t(theta_np, device, dtype)


def info_to_numpy(info: SolveInfo) -> dict:
    """SolveInfo as a dict of numpy arrays (field name -> (B,) array)."""
    return {f: getattr(info, f).detach().cpu().numpy() for f in SolveInfo._fields}
