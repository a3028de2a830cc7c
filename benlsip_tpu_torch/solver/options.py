"""Solver hyperparameter configuration (PyTorch port).

Field-by-field twin of `benlsip_tpu/solver/options.py`: same names, same
defaults, same `resolve_tols`.  `unroll_limit` is not carried over (an XLA
compile-time knob; eager PyTorch has no unrolled-program variant).

`verbose=True` prints the reference's iteration log (`harness/logging`)
from eager loops; a route whose loops are captured into CUDA graphs
(`fuse=True`) refuses it with `ValueError` before any capture.

`matmul_precision` names the float32 matmul precision of a solve, as JAX's
`default_matmul_precision` does.  On the card the only reduced precision
is TF32: "highest" and "float32" keep float32 matmuls exact (TF32 off),
"default", "high" and "tensorfloat32" turn TF32 on (JAX on an NVIDIA GPU
reads "default" as TF32 too).  `solve_fixed_point` applies it to its whole
iteration through `matmul_precision()` and restores the flag on exit.  The
CPU has no TF32, so there the value changes no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Optional

import torch

# matmul_precision value -> whether float32 matmuls on the card may use TF32.
MATMUL_PRECISIONS = {"highest": False, "float32": False, "default": True, "high": True, "tensorfloat32": True}


def allows_tf32(precision: str) -> bool:
    """Whether a matmul_precision value turns TF32 on."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision={precision!r}: expected one of {', '.join(map(repr, MATMUL_PRECISIONS))}")
    return MATMUL_PRECISIONS[precision]


@contextlib.contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """Run the block with `torch.backends.cuda.matmul.allow_tf32` set from
    a matmul_precision value; the previous value comes back on exit, also
    when the block raises.  The flag is global to the process."""
    tf32 = allows_tf32(precision)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
    matmul_precision: str = "highest"  # "highest" = true f32 matmuls (TF32 off); see MATMUL_PRECISIONS
    project_x0: bool = True
    gram_hessian: str = "auto"
    gn_factorization: str = "auto"
    linear_residuals: bool = False
    tr_factor: float = 0.1
    chol_reg: float = 0.0
    # The mesh dim the residual dimension is sharded over in the
    # explicit-collective blocked mode (`dist/sharded.solve_large_blocked_shardmap`):
    # every contraction over it carries a psum (`dist/collectives.py`).
    spmd_axis: Optional[str] = None
    # Under spmd_axis: the materialized operator whole on every rank
    # ("replicated", one all-reduce per refresh) or as each rank's n/D rows
    # ("sharded": a reduce-scatter per refresh, an all_gather per H·v).
    gram_layout: str = "replicated"
    # How the sharded Gram is reduce-scattered: "xla" (one reduce_scatter)
    # or "ring" (D−1 point-to-point hops, chunks built as the ring needs them).
    reduce_schedule: str = "xla"
    verbose: bool = False

    def __post_init__(self):
        if not (0 < self.eta1 <= self.eta2 < 1 and 0 < self.gamma1 < 1 < self.gamma2):
            raise ValueError("Invalid trust region updates parameters")
        allows_tf32(self.matmul_precision)

    def resolve_tols(self, dtype: torch.dtype) -> "SolverOptions":
        """Fill None tolerances with sqrt(eps(dtype))."""
        se = math.sqrt(torch.finfo(dtype).eps)
        return dataclasses.replace(
            self,
            feas_tol=self.feas_tol if self.feas_tol is not None else se,
            crit_tol=self.crit_tol if self.crit_tol is not None else se,
        )
