"""benlsip_tpu_torch — the PyTorch/CUDA port of benlsip_tpu.

A batch-first PyTorch twin of the JAX package's constrained nonlinear
least-squares solver (TRALCNLLS) for

    min_x 1/2 ‖r(x)‖²   s.t.  c(x) = 0,  A x = b,  xl ≤ x ≤ xu,

with the JAX package's module layout: `ops` (constraint algebra),
`solver`, `batch`, `problems` and `kernels` (hand-written CUDA kernels for
Hopper, each with a plain PyTorch version used on CPU tensors).  The port
imports torch and numpy, never jax.

Public surface: `tralcnllss` (reference-parity entry), `solve`/`Problem`
(idiomatic entry), `least_squares` (scipy's call surface), `solve_qp`,
`with_inequalities` and `SolverOptions` for one instance;
`batch.refine.solve_mixed_precision` on a `batch.vmap_solve.BatchedProblem`
for batches.  Entry points that create tensors take `device`; None is the
CUDA card (`_device.resolve_device`), and tests pass "cpu".  Importing the
package builds no kernel and touches no CUDA state.
"""
from .compat import OptimizeResult, least_squares
from .ops.al import AlHessian, evaluate_al, hv, new_point, vhv
from .ops.constraints import ActiveSet, Polyhedron, is_feasible
from .ops.polyproject import projection_polyhedron
from .ops.project import project_tangent
from .solver.api import NLSFunctions, Problem, solve, tralcnllss
from .solver.options import SolverOptions
from .solver.outer import SolveInfo
from .solver.qp import QPInfo, solve_qp
from .solver.transforms import LiftedProblem, with_inequalities

__version__ = "0.1.0"

__all__ = [
    "AlHessian",
    "ActiveSet",
    "NLSFunctions",
    "Polyhedron",
    "Problem",
    "SolveInfo",
    "SolverOptions",
    "evaluate_al",
    "hv",
    "is_feasible",
    "new_point",
    "project_tangent",
    "projection_polyhedron",
    "LiftedProblem",
    "OptimizeResult",
    "least_squares",
    "with_inequalities",
    "solve",
    "solve_qp",
    "QPInfo",
    "tralcnllss",
    "vhv",
]
