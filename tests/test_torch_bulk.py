"""The port's batched f32/f64 bulk solve (benlsip_tpu_torch.batch.vmap_solve
over solver/outer → subproblem → inner → cg) against the JAX package on the
config-2 family (exp_fit_family, n=3, d=16, box bounds, one equality).

Both sides get bit-identical data from the same numpy recipe.  Tolerances:
f64 — the same status on every lane and X within 1e-7 (the iterations are
the same algorithm; only rounding differs, and a lane sitting at the f64
criticality floor may spend a different number of iterations there);
f32 — X within 1e-4 (the f32 bulk's accuracy budget).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.batch.vmap_solve import solve_batched_chunked as j_solve
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked, map_poly_fields, poly_batch_axes
from benlsip_tpu_torch.interop import info_to_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)


@pytest.mark.parametrize("with_constraints", [True, False])
def test_generator_bit_identical(with_constraints):
    bp_j, th_j, X0_j = j_exp_fit(24, d=16, seed=5, with_constraints=with_constraints)
    bp_t, th_t, X0_t = exp_fit_family(24, d=16, seed=5, with_constraints=with_constraints, device="cpu")
    for k in ("t", "y"):
        np.testing.assert_array_equal(th_t[k].numpy(), np.asarray(th_j[k]))
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    for f in ("A", "b", "xl", "xu"):
        a_j, a_t = getattr(bp_j, f), getattr(bp_t, f)
        assert (a_j is None) == (a_t is None)
        if a_j is not None:
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert bp_t.poly_batched == bp_j.poly_batched
    # float32 data round the same way.
    _, th_j32, X0_j32 = j_exp_fit(8, d=16, seed=5, dtype=jnp.float32)
    _, th_t32, X0_t32 = exp_fit_family(8, d=16, seed=5, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(th_t32["y"].numpy(), np.asarray(th_j32["y"]))
    np.testing.assert_array_equal(X0_t32.numpy(), np.asarray(X0_j32))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_bulk_matches_jax(dtype):
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    bp_j, th_j, X0_j = j_exp_fit(16, d=16, seed=0, dtype=jd)
    Xj, _, ij = j_solve(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=16)
    bp_t, th_t, X0_t = exp_fit_family(16, d=16, seed=0, dtype=td, device="cpu")
    Xt, Yt, it = solve_batched_chunked(bp_t, th_t, X0_t, SolverOptions(**OPTS), chunk=16)
    info = info_to_numpy(it)
    assert Xt.dtype == td and Yt.shape == (16, 0)
    np.testing.assert_array_equal(info["status"], np.asarray(ij.status))
    np.testing.assert_array_equal(info["converged"], np.asarray(ij.converged))
    assert info["converged"].all()
    atol = 1e-7 if dtype == "f64" else 1e-4
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=atol)


def test_pipeline_reaches_kernel_gate_in_f32(monkeypatch):
    # On CPU tensors the kernel wrappers run their plain versions; count
    # those calls and their dtypes through one small pipeline run.  The f32
    # bulk must hand float32 (no silent promotion) to the Cholesky and solve
    # gates, the certification float32 to the QR gate, and the f64 fallback
    # / projections nothing (they go to torch.linalg).
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    seen = {"batched_cholesky_plain": [], "batched_cho_solve_plain": [], "batched_thin_qr_plain": []}
    for name in seen:
        orig = getattr(kern, name)

        def spy(*args, _orig=orig, _name=name):
            seen[_name].append(args[0].dtype)
            return _orig(*args)

        monkeypatch.setattr(kern, name, spy)
    bp, th, X0 = exp_fit_family(8, d=16, seed=3, device="cpu")
    X, _, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=8)
    assert bool(info.converged.all()) and X.dtype == torch.float64
    for name, dtypes in seen.items():
        assert dtypes and set(dtypes) == {torch.float32}, (name, set(dtypes))
    assert sum(kern.LAUNCHES.values()) == 0   # CPU tensors never launch


def test_chunk_independence_and_poly_helpers():
    # Per-lane results do not depend on the chunk width: each lane's loops
    # stop on its own predicate, so chunk=16 and chunk=8 give identical X.
    bp, th, X0 = exp_fit_family(16, d=16, seed=2, dtype=torch.float32, device="cpu")
    opts = SolverOptions(**OPTS)
    X16, _, i16 = solve_batched_chunked(bp, th, X0, opts, chunk=16)
    X8, _, i8 = solve_batched_chunked(bp, th, X0, opts, chunk=8)
    X5, _, _ = solve_batched_chunked(bp, th, X0, opts, chunk=5)   # ragged tail
    torch.testing.assert_close(X8, X16, rtol=0, atol=0)
    torch.testing.assert_close(X5, X16, rtol=0, atol=0)
    torch.testing.assert_close(i8.outer_iters, i16.outer_iters, rtol=0, atol=0)

    poly = bp.polyhedron(3, torch.float32, 16, "cpu")
    assert poly.A.shape == (16, 1, 3) and poly.xl.shape == (16, 3)
    assert poly_batch_axes(type(poly)(bp.A, bp.b, bp.xl, bp.xu)) == (None, 0, None, None)
    sub = map_poly_fields(bp, lambda a: a[:4])
    assert sub.b.shape == (4, 1) and sub.A is bp.A
