"""The bf16 bulk on the two other families the port supports, against the
JAX package's bf16 pipeline and the port's float32-bulk run.

* `sphere_family(16, seed=21)`: one nonlinear equality per instance, so the
  bf16 bulk runs the multiplier estimate's `thin_qr(Cᵀ)` at p = 1 through
  the QR kernel's gate (its plain version here).
* `dense_quadratic_family(4, n=64, d=128, m=2, seed=5)`: n ≥ 64 and
  d ≥ 2n, so the bulk materializes the CholeskyQR2 operator from a bf16 J
  (`OPERATOR_BUILDS` holds `cholqr2/bfloat16` and no float32 build).  In
  bf16 the bulk stalls short of its 1e-2 criticality (pix noise at
  eps_bf16 = 2⁻⁷), in the JAX package too, and the polish certifies from
  there.  The config-3 shape (n = 192, d = 1024) is cut to the smallest
  that still materializes, to keep the eager CPU run short.

Gates, the JAX package's own (tests/test_refine.py): every lane certified
at pix ≤ 1.49e-8, X within rtol 1e-7 / atol 1e-8 of the JAX package's bf16
run and of the port's float32-bulk run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch import refine as j_refine
from benlsip_tpu.problems import generators as j_gen
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.problems import generators as t_gen
from benlsip_tpu_torch.solver import subproblem
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)

FAMILIES = {
    "sphere": (lambda mod, **kw: mod.sphere_family(16, seed=21, **kw), dict(max_outer_iter=100, max_inner_iter=300), 16),
    "dense": (lambda mod, **kw: mod.dense_quadratic_family(4, n=64, d=128, m=2, seed=5, **kw),
              dict(max_outer_iter=30, max_inner_iter=100), 4),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_bulk_family_matches_jax(name):
    make, opts, chunk = FAMILIES[name]
    bp, th, X0 = make(t_gen, device="cpu")
    subproblem.reset_operator_builds()
    X, Y, info = solve_mixed_precision(bp, th, X0, SolverOptions(**opts), chunk=chunk, bulk_dtype=torch.bfloat16)
    builds = dict(subproblem.OPERATOR_BUILDS)
    assert bool(info.converged.all()) and float(info.pix.max()) <= 1.49e-8
    if name == "dense":
        assert builds[("cholqr2", "bfloat16")] > 0
        assert not [k for k in builds if k[1] == "float32"], builds
    else:
        assert builds == {} and float(info.feas.max()) <= 1.49e-8
    Xf, _, info_f = solve_mixed_precision(bp, th, X0, SolverOptions(**opts), chunk=chunk)
    assert bool(info_f.converged.all())
    np.testing.assert_allclose(X.numpy(), Xf.numpy(), rtol=1e-7, atol=1e-8)

    bp_j, th_j, X0_j = make(j_gen, dtype=jnp.float64)
    Xj, _, ij = j_refine.solve_mixed_precision(bp_j, th_j, X0_j, JOptions(**opts), chunk=chunk, bulk_dtype=jnp.bfloat16)
    assert np.asarray(ij.converged).all()
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-7, atol=1e-8)
