"""Solver hyperparameter configuration (PyTorch port).

Field-by-field twin of `benlsip_tpu/solver/options.py`: same names, same
defaults, same `resolve_tols`.  `unroll_limit` is not carried over (an XLA
compile-time knob; eager PyTorch has no unrolled-program variant).

Knobs whose route is not ported yet raise `NotImplementedError` at
construction when set to a non-default value, so a request for an
unported path never silently runs a different one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# Non-default values of these fields select routes the port does not have
# yet (sharded blocked mode, materialized Gram operators, linear-residual
# caches, host iteration logs, reduced-precision matmuls).
_UNPORTED_DEFAULTS = {
    "spmd_axis": None,
    "gram_layout": "replicated",
    "reduce_schedule": "xla",
    "linear_residuals": False,
    "verbose": False,
    "matmul_precision": "highest",
}


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Hyperparameters of the TRALCNLLS iteration.

    Tolerances defaulting to sqrt(eps(T)) are encoded as None and resolved
    against the working dtype at solve time (`resolve_tols`).  See the JAX
    package's `SolverOptions` for the meaning of every field.
    """

    # Outer augmented-Lagrangian loop
    mu0: float = 10.0
    tau: float = 100.0
    omega0: float = 1.0
    eta0: float = 1.0
    feas_tol: Optional[float] = None
    crit_tol: Optional[float] = None
    k_crit: float = 1.0
    k_feas: float = 0.1
    beta_crit: float = 1.0
    beta_feas: float = 0.9

    # Trust-region control
    eta1: float = 0.25
    eta2: float = 0.75
    gamma1: float = 0.0625
    gamma2: float = 2.0
    gamma_c: float = 10.0

    # Inner/CG tolerances
    kappa1: float = 1e-2
    kappa2: float = 0.1
    kappa3: float = 0.1
    cauchy_max_trials: int = 16
    projected_cauchy_threshold: int = 32

    # Iteration caps
    max_outer_iter: int = 500
    max_inner_iter: int = 500
    max_minor_iter: int = 50

    # Stall detection
    stall_window: int = 12
    stall_ratio: float = 0.99
    outer_stall_window: int = 6

    # Knobs absent in the reference
    matmul_precision: str = "highest"  # "highest" = true f32 matmuls (TF32 off)
    project_x0: bool = True
    gram_hessian: str = "auto"         # "on" is not ported; "auto" may resolve on
    gn_factorization: str = "auto"
    linear_residuals: bool = False
    tr_factor: float = 0.1
    chol_reg: float = 0.0
    spmd_axis: Optional[str] = None
    gram_layout: str = "replicated"
    reduce_schedule: str = "xla"
    verbose: bool = False

    def __post_init__(self):
        if not (0 < self.eta1 <= self.eta2 < 1 and 0 < self.gamma1 < 1 < self.gamma2):
            raise ValueError("Invalid trust region updates parameters")
        for name, default in _UNPORTED_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"SolverOptions.{name}={getattr(self, name)!r}: this route is not "
                    f"ported to benlsip_tpu_torch yet (only {default!r})"
                )
        if self.gram_hessian == "on":
            raise NotImplementedError(
                "SolverOptions.gram_hessian='on': the materialized-operator route "
                "is not ported to benlsip_tpu_torch yet"
            )

    def resolve_tols(self, dtype: torch.dtype) -> "SolverOptions":
        """Fill None tolerances with sqrt(eps(dtype))."""
        se = math.sqrt(torch.finfo(dtype).eps)
        return dataclasses.replace(
            self,
            feas_tol=self.feas_tol if self.feas_tol is not None else se,
            crit_tol=self.crit_tol if self.crit_tol is not None else se,
        )
