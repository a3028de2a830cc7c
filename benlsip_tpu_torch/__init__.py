"""benlsip_tpu_torch — the PyTorch/CUDA port of benlsip_tpu.

A batch-first PyTorch twin of the JAX package's constrained nonlinear
least-squares solver (TRALCNLLS) for

    min_x 1/2 ‖r(x)‖²   s.t.  c(x) = 0,  A x = b,  xl ≤ x ≤ xu,

with the JAX package's module layout: `ops` (constraint algebra),
`solver`, `batch`, `problems` and `kernels` (hand-written CUDA kernels for
Hopper, each with a plain PyTorch version used on CPU tensors).  The port
imports torch and numpy, never jax.

Entry point of the ported slice: `batch.refine.solve_mixed_precision` on
`problems.generators.exp_fit_family`.
"""
from .solver.options import SolverOptions

__version__ = "0.1.0"

__all__ = ["SolverOptions"]
