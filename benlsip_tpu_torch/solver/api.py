"""Batched problem callables (PyTorch port of `NLSFunctions` in
`benlsip_tpu/solver/api.py`).

The solver works on batches: every callable takes X (B, n) and returns the
batch's residuals (B, d), constraints (B, p) or Jacobians (B, d, n) /
(B, p, n).  `batch/vmap_solve.BatchedProblem.instance_fns` builds them
from per-instance functions with `torch.func.vmap` and, for the
Jacobians, `torch.func.vmap(torch.func.jacfwd(...))`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NLSFunctions:
    """Batched callables of an NLS problem family (p may be 0)."""

    residuals: Callable[[Tensor], Tensor]
    nlconstraints: Callable[[Tensor], Tensor]
    jac_res: Callable[[Tensor], Tensor]
    jac_nlcons: Callable[[Tensor], Tensor]
