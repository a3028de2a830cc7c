"""The port's nonlinear-constraint path (p > 0) against the JAX package:
`sphere_family` (n=3, d=4, p=1, m=1) through the generator, the multiplier
estimate, the float64 batched solve and the mixed-precision pipeline, and
the dtype of autodiff Jacobians.

Both sides draw the same numbers from `np.random.default_rng(seed)`.
Tolerances on the CPU: theta bit-identical; float64 `solve_batched`
within 1e-7 in X and Y with equal outer iteration counts, μ and status;
`solve_mixed_precision` a `converged` mask that holds the JAX package's
(the port's polish carries the Lagrangian's curvature where p > 0, ROADMAP
§1), X and Y within 1e-7 on the JAX package's certified lanes, pix ≤
sqrt(eps(f64)) ≈ 1.49e-8 on every certified lane and the KKT oracle on each
lane only the port certifies; the multiplier estimate within 1e-9 in both
methods.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.baselines.kkt_oracle import kkt_check_point as j_kkt_check_point
from benlsip_tpu.batch.refine import solve_mixed_precision as j_mixed
from benlsip_tpu.batch.vmap_solve import solve_batched as j_solve_batched
from benlsip_tpu.problems.generators import sphere_family as j_sphere_family
from benlsip_tpu.solver import multipliers as j_mult
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem, solve_batched
from benlsip_tpu_torch.interop import info_to_numpy
from benlsip_tpu_torch.problems.generators import sphere_family
from benlsip_tpu_torch.solver.multipliers import least_squares_multipliers
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=100, max_inner_iter=300)
CERT_PIX = float(np.sqrt(np.finfo(np.float64).eps))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sphere_family_bit_identical(dtype):
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    bp_j, th_j, X0_j = j_sphere_family(24, seed=5, dtype=jd)
    bp_t, th_t, X0_t = sphere_family(24, seed=5, dtype=td, device="cpu")
    assert sorted(th_t) == sorted(th_j) == ["off", "rad"]
    for k in th_j:
        assert th_t[k].dtype == td
        np.testing.assert_array_equal(th_t[k].numpy(), np.asarray(th_j[k]))
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    for f in ("A", "b", "xl", "xu"):
        np.testing.assert_array_equal(getattr(bp_t, f).numpy(), np.asarray(getattr(bp_j, f)))
    assert bp_t.poly_batched == bp_j.poly_batched is False
    # The callables agree at the start (shapes d = 4, p = 1, n = 3).
    fns = bp_t.instance_fns(th_t)
    one = lambda f: jax.vmap(lambda th, x: f(bp_j.instance_fns(th))(x))(th_j, X0_j)
    tol = dict(rtol=0, atol=1e-14 if dtype == "f64" else 1e-6)
    np.testing.assert_allclose(fns.residuals(X0_t).numpy(), np.asarray(one(lambda s: s.residuals)), **tol)
    np.testing.assert_allclose(fns.nlconstraints(X0_t).numpy(), np.asarray(one(lambda s: s.nlconstraints)), **tol)
    np.testing.assert_allclose(fns.jac_res(X0_t).numpy(), np.asarray(one(lambda s: s.jac_res)), **tol)
    np.testing.assert_allclose(fns.jac_nlcons(X0_t).numpy(), np.asarray(one(lambda s: s.jac_nlcons)), **tol)


@pytest.mark.parametrize("family", ["indexed_constant", "sphere_family"])
def test_autodiff_jacobians_keep_the_dtype_of_x(family):
    # torch.func.jacfwd of a function that mixes an indexed coordinate with
    # a Python float can return a float64 Jacobian for a float32 x.
    if family == "indexed_constant":
        bp = BatchedProblem(
            residuals=lambda x, th: torch.stack([x[0] - 1.5, x[1]]),
            nlconstraints=lambda x, th: torch.stack([0.5 * torch.cos(2 * x[0]) + (x[1] - 1.0) ** 2]),
        )
        theta, X = {"unused": torch.zeros(5)}, torch.linspace(-1.0, 1.0, 10, dtype=torch.float32).reshape(5, 2)
    else:
        bp, theta, X = sphere_family(8, seed=2, dtype=torch.float32, device="cpu")
    fns = bp.instance_fns(theta)
    for name in ("residuals", "nlconstraints", "jac_res", "jac_nlcons"):
        assert getattr(fns, name)(X).dtype == torch.float32, name
    # A hand-written Jacobian is passed through as given.
    import dataclasses

    J64 = torch.ones((fns.residuals(X).shape[1], X.shape[1]), dtype=torch.float64)
    given = dataclasses.replace(bp, jac_res=lambda x, th: J64).instance_fns(theta)
    assert given.jac_res(X).dtype == torch.float64


def test_mixed_precision_runs_on_float32_sphere_family():
    # The bulk of the pipeline is a float32 solve with p = 1: the multiplier
    # estimate's QR and every Jacobian product see one dtype.
    bp, theta, X0 = sphere_family(8, seed=0, device="cpu")
    X, Y, info = solve_mixed_precision(bp, theta, X0, SolverOptions(**OPTS), chunk=8)
    assert X.dtype == Y.dtype == torch.float64 and Y.shape == (8, 1)
    assert int(info.converged.sum()) == 8 and float(info.pix.max()) <= CERT_PIX


@pytest.mark.parametrize("method", ["qr", "normal"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_least_squares_multipliers_sphere_family(method, dtype):
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    B = 6
    bp_j, th_j, _ = j_sphere_family(B, seed=9, dtype=jd)
    bp_t, th_t, _ = sphere_family(B, seed=9, dtype=td, device="cpu")
    X = np.random.default_rng(9).uniform(0.2, 1.2, (B, 3))

    def one(th, x):
        f = bp_j.instance_fns(th)
        return j_mult.least_squares_multipliers(x, f.residuals, f.jac_res, f.jac_nlcons, method=method)

    want = np.asarray(jax.vmap(one)(th_j, jnp.asarray(X, jd)))
    got = least_squares_multipliers(torch.as_tensor(X, dtype=td), bp_t.instance_fns(th_t), method=method)
    assert got.shape == (B, 1) and got.dtype == td
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 if dtype == "f64" else 1e-4)


def test_solve_batched_f64_matches_jax():
    B = 16
    bp_j, th_j, X0_j = j_sphere_family(B, seed=3)
    Xj, Yj, ij = j_solve_batched(bp_j, th_j, X0_j, JOptions(**OPTS))
    bp_t, th_t, X0_t = sphere_family(B, seed=3, device="cpu")
    Xt, Yt, it = solve_batched(bp_t, th_t, X0_t, SolverOptions(**OPTS))
    info = info_to_numpy(it)
    assert Yt.shape == (B, 1) and info["converged"].all()
    np.testing.assert_array_equal(info["converged"], np.asarray(ij.converged))
    np.testing.assert_array_equal(info["status"], np.asarray(ij.status))
    np.testing.assert_array_equal(info["outer_iters"], np.asarray(ij.outer_iters))
    np.testing.assert_array_equal(info["mu"], np.asarray(ij.mu))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=1e-7)
    # The multiplier update y ← y + μc ran: the lanes took several outer iterations.
    assert info["outer_iters"].min() >= 2
    assert float(info["feas"].max()) <= CERT_PIX


def test_mixed_precision_matches_jax():
    # The port's polish carries the Lagrangian's curvature where p > 0 (a
    # deliberate difference, ROADMAP §1): it certifies lanes that the JAX
    # package's Gauss-Newton polish and its fallback refine leave, so the
    # port's certified set holds the JAX package's, the two agree on it, and
    # each lane only the port certifies passes the first-principles KKT
    # oracle at the certificate's tolerance.
    B = 32
    bp_j, th_j, X0_j = j_sphere_family(B, seed=21)
    Xj, Yj, ij = j_mixed(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=B)
    bp_t, th_t, X0_t = sphere_family(B, seed=21, device="cpu")
    Xt, Yt, it = solve_mixed_precision(bp_t, th_t, X0_t, SolverOptions(**OPTS), chunk=B)
    conv, conv_j = it.converged.numpy(), np.asarray(ij.converged)
    assert (conv | ~conv_j).all()          # the port's certified set ⊇ the JAX package's
    assert conv_j.mean() >= 0.9   # the JAX package's own bar (tests/test_refine.py)
    np.testing.assert_allclose(Xt.numpy()[conv_j], np.asarray(Xj)[conv_j], rtol=0, atol=1e-7)
    np.testing.assert_allclose(Yt.numpy()[conv_j], np.asarray(Yj)[conv_j], rtol=0, atol=1e-7)
    assert float(it.pix[it.converged].max()) <= CERT_PIX
    assert float(it.feas[it.converged].max()) <= CERT_PIX
    fns = bp_t.instance_fns(th_t)
    R, Jr = fns.residuals(Xt).numpy(), fns.jac_res(Xt).numpy()
    c, C = fns.nlconstraints(Xt).numpy(), fns.jac_nlcons(Xt).numpy()
    A, b, xl, xu = (t.numpy() for t in (bp_t.A, bp_t.b, bp_t.xl, bp_t.xu))
    for i in np.flatnonzero(conv & ~conv_j):
        assert j_kkt_check_point(Xt[i].numpy(), R[i], Jr[i], c[i], C[i], A, b, xl, xu)["ok"], i
    # certify="host" certifies the same lanes at the same points.
    Xh, _, ih = solve_mixed_precision(bp_t, th_t, X0_t, SolverOptions(**OPTS), chunk=B, certify="host")
    np.testing.assert_array_equal(ih.converged.numpy(), conv)
    np.testing.assert_allclose(Xh.numpy()[conv], Xt.numpy()[conv], rtol=0, atol=1e-7)
    assert float(ih.pix[ih.converged].max()) <= CERT_PIX


def test_chunking_does_not_change_lanes():
    bp, theta, X0 = sphere_family(12, seed=4, device="cpu")
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked

    Xa, Ya, ia = solve_batched_chunked(bp, theta, X0, SolverOptions(**OPTS), chunk=12)
    Xb, Yb, ib = solve_batched_chunked(bp, theta, X0, SolverOptions(**OPTS), chunk=5)
    np.testing.assert_allclose(Xb.numpy(), Xa.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Yb.numpy(), Ya.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(ib.outer_iters.numpy(), ia.outer_iters.numpy())
