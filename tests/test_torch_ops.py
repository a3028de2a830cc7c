"""Constraint algebra of the port (benlsip_tpu_torch/ops) against the JAX
package, in float64, on the HS48 fixture and on random batched polyhedra.

The JAX functions are single-instance and are lifted with jax.vmap; the
port's functions are batch-first.  Inputs come from a seeded numpy
generator and go through both.  Tolerance 1e-11: float64 on both sides with
LAPACK factorizations, so only summation order differs.  The projection's
dual Newton stops at its own tolerance (eps^0.75 relative), so projected
points are held to 1e-10.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.ops import al as jal
from benlsip_tpu.ops import cholesky as jchol
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import polyproject as jpp
from benlsip_tpu.ops import project as jpr
from benlsip_tpu.problems import hs48
from benlsip_tpu.solver import inner as jinner
from benlsip_tpu.solver import multipliers as jmult
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.ops import al as tal
from benlsip_tpu_torch.ops import cholesky as tchol
from benlsip_tpu_torch.ops import constraints as tc
from benlsip_tpu_torch.ops import polyproject as tpp
from benlsip_tpu_torch.ops import project as tpr
from benlsip_tpu_torch.solver import inner as tinner
from benlsip_tpu_torch.solver import multipliers as tmult
from benlsip_tpu_torch.solver.api import NLSFunctions
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
rng = np.random.default_rng(11)
TOL = dict(rtol=1e-11, atol=1e-11)


def batched_polys(B=6, n=5, m=2, width=0.4):
    A = rng.standard_normal((B, m, n))
    x_feas = rng.standard_normal((B, n))
    b = np.einsum("bmn,bn->bm", A, x_feas)
    xl, xu = x_feas - width, x_feas + width
    return A, b, xl, xu, x_feas


def hs48_polys(B=4):
    A = np.broadcast_to(np.asarray(hs48.A), (B, 2, 5)).copy()
    b = np.broadcast_to(np.asarray(hs48.b), (B, 2)).copy()
    xl = np.full((B, 5), -4.0) + rng.uniform(-0.5, 0.0, (B, 5))
    xu = np.full((B, 5), 4.0) + rng.uniform(0.0, 0.5, (B, 5))
    return A, b, xl, xu, np.ones((B, 5))


def to_j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def to_t(*arrs):
    return [torch.as_tensor(np.asarray(a)) for a in arrs]


def jpoly(A, b, xl, xu):
    return jc.Polyhedron(*to_j(A, b, xl, xu))


def tpoly(A, b, xl, xu):
    return tc.Polyhedron(*to_t(A, b, xl, xu))


POLY_AXES = jc.Polyhedron(0, 0, 0, 0)


@pytest.mark.parametrize("maker", [batched_polys, hs48_polys], ids=["random", "hs48"])
def test_active_set_factor_and_projection(maker):
    A, b, xl, xu, _ = maker()
    B, m, n = A.shape
    fixed = rng.random((B, n)) < 0.35
    r = rng.standard_normal((B, n))
    jp, tp = jpoly(A, b, xl, xu), tpoly(A, b, xl, xu)

    ja = jax.vmap(jc.make_active_set, in_axes=(POLY_AXES, 0))(jp, jnp.asarray(fixed))
    ta = tc.make_active_set(tp, torch.as_tensor(fixed))
    np.testing.assert_allclose(ta.chol.numpy(), np.asarray(ja.chol), **TOL)

    jv = jax.vmap(jpr.project_tangent, in_axes=(POLY_AXES, jc.ActiveSet(0, 0), 0))(jp, ja, jnp.asarray(r))
    tv = tpr.project_tangent(tp, ta, torch.as_tensor(r))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jn = jax.vmap(jpr.norm_reduced_gradient, in_axes=(POLY_AXES, jc.ActiveSet(0, 0), 0))(jp, ja, jnp.asarray(r))
    np.testing.assert_allclose(tpr.norm_reduced_gradient(tp, ta, torch.as_tensor(r)).numpy(), np.asarray(jn), **TOL)

    # Masked factor + solve directly (ops/cholesky).
    free = ~fixed
    rhs = rng.standard_normal((B, m))
    jL = jax.vmap(jchol.factor_masked_aat, in_axes=(0, 0))(jnp.asarray(A), jnp.asarray(free))
    tL = tchol.factor_masked_aat(torch.as_tensor(A), torch.as_tensor(free))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), **TOL)
    jx = jax.vmap(jchol.cho_solve_lower)(jL, jnp.asarray(rhs))
    np.testing.assert_allclose(tchol.cho_solve_lower(tL, torch.as_tensor(rhs)).numpy(), np.asarray(jx), rtol=1e-10, atol=1e-10)


def test_bound_masks_and_coupled_release():
    A, b, xl, xu, x_feas = batched_polys(B=8)
    B, m, n = A.shape
    x = x_feas
    # Put about half of the coordinates on a bound, keeping m of them free:
    # with fewer than m free, A Z Aᵀ is exactly singular and whether LAPACK
    # reports failure or a tiny pivot is rounding (both sides guard it).
    on = rng.random((B, n)) < 0.5
    on[:, :m] = False
    lo = rng.random((B, n)) < 0.5
    x = np.where(on & lo, xl, np.where(on, xu, x))
    g = rng.standard_normal((B, n))
    s = rng.standard_normal((B, n)) * 0.3
    delta = rng.uniform(0.1, 0.5, B)
    jp, tp = jpoly(A, b, xl, xu), tpoly(A, b, xl, xu)
    jx, jg, js, jd = to_j(x, g, s, delta)
    tx, tg, ts, td = to_t(x, g, s, delta)
    atol = 1e-9

    pairs = [
        (jax.vmap(jc.active_bounds_at, in_axes=(POLY_AXES, 0, None))(jp, jx, atol),
         tc.active_bounds_at(tp, tx, atol)),
        (jax.vmap(jc.step_active_bounds, in_axes=(POLY_AXES, 0, 0, 0, None))(jp, jx, js, jd, atol),
         tc.step_active_bounds(tp, tx, ts, td, atol)),
        (jax.vmap(jc.binding_bounds_at, in_axes=(POLY_AXES, 0, 0, None))(jp, jx, jg, atol),
         tc.binding_bounds_at(tp, tx, tg, atol)),
        (jax.vmap(jc.binding_bounds_coupled, in_axes=(POLY_AXES, 0, 0, None))(jp, jx, jg, atol),
         tc.binding_bounds_coupled(tp, tx, tg, atol)),
        (jax.vmap(jc.is_feasible, in_axes=(POLY_AXES, 0))(jp, jx), tc.is_feasible(tp, tx)),
    ]
    for k, (jm, tm) in enumerate(pairs):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=f"mask {k}")
    np.testing.assert_array_equal(tc.is_feasible(tp, torch.as_tensor(x_feas)).numpy(), True)

    # add_active by mask and by per-lane index; no_active_set.
    aset = tc.no_active_set(tp)
    ja0 = jax.vmap(jc.no_active_set, in_axes=(POLY_AXES,))(jp)
    np.testing.assert_allclose(aset.chol.numpy(), np.asarray(ja0.chol), **TOL)
    idx = rng.integers(0, n, B)
    ja1 = jax.vmap(jc.add_active, in_axes=(POLY_AXES, jc.ActiveSet(0, 0), 0))(jp, ja0, jnp.asarray(idx))
    ta1 = tc.add_active(tp, aset, torch.as_tensor(idx))
    np.testing.assert_array_equal(ta1.fixed.numpy(), np.asarray(ja1.fixed))
    np.testing.assert_allclose(ta1.chol.numpy(), np.asarray(ja1.chol), **TOL)
    mask = rng.random((B, n)) < 0.3
    ja2 = jax.vmap(jc.add_active, in_axes=(POLY_AXES, jc.ActiveSet(0, 0), 0))(jp, ja1, jnp.asarray(mask))
    ta2 = tc.add_active(tp, ta1, torch.as_tensor(mask))
    np.testing.assert_array_equal(ta2.fixed.numpy(), np.asarray(ja2.fixed))
    assert (tc.nb_fix(ta2).numpy() == np.asarray(jax.vmap(jc.nb_fix)(ja2))).all()


def test_al_operators_match():
    B, d, p, n = 5, 7, 2, 4
    J, C, v = rng.standard_normal((B, d, n)), rng.standard_normal((B, p, n)), rng.standard_normal((B, n))
    mu = rng.uniform(1.0, 100.0, B)
    r, c, y = rng.standard_normal((B, d)), rng.standard_normal((B, p)), rng.standard_normal((B, p))
    jH = jal.AlHessian(*to_j(J, C, mu))
    tH = tal.AlHessian(*to_t(J, C, mu))
    hv_ax = (jal.AlHessian(0, 0, 0), 0)
    np.testing.assert_allclose(tal.hv(tH, torch.as_tensor(v)).numpy(), np.asarray(jax.vmap(jal.hv, in_axes=hv_ax)(jH, jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(tal.vhv(tH, torch.as_tensor(v)).numpy(), np.asarray(jax.vmap(jal.vhv, in_axes=hv_ax)(jH, jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(
        tal.al_value(*to_t(r, c, y, mu)).numpy(), np.asarray(jax.vmap(jal.al_value)(*to_j(r, c, y, mu))), **TOL)
    y_bar = y + mu[:, None] * c
    np.testing.assert_allclose(
        tal.al_gradient(*to_t(J, C, r, y_bar)).numpy(),
        np.asarray(jax.vmap(jal.al_gradient)(*to_j(J, C, r, y_bar))), **TOL)
    # p == 0 blocks.
    tH0 = tal.AlHessian(torch.as_tensor(J), torch.zeros((B, 0, n), dtype=torch.float64), torch.as_tensor(mu))
    np.testing.assert_allclose(tal.hv(tH0, torch.as_tensor(v)).numpy(), np.einsum("bdn,bd->bn", J, np.einsum("bdn,bn->bd", J, v)), **TOL)


def _sphere_like(B, n=3, d=4):
    """A residual/constraint pair with p = 1, for the multiplier and
    new_point parity (exp_fit has p = 0)."""
    off = rng.uniform(-0.1, 0.1, (B, d))
    X = rng.uniform(-1.0, 1.0, (B, n))

    def j_res(x, o):
        return jnp.stack([x[0] ** 2 + x[1] - 1.0, x[1] * x[2], jnp.sin(x[0]) - x[2], x[0] * x[1] * x[2]]) + o

    def j_con(x):
        return jnp.stack([jnp.sum(x * x) - 3.0])

    def t_res(x, o):
        return torch.stack([x[0] ** 2 + x[1] - 1.0, x[1] * x[2], torch.sin(x[0]) - x[2], x[0] * x[1] * x[2]]) + o

    def t_con(x, o):
        return torch.stack([torch.sum(x * x) - 3.0])

    vm, jf = torch.func.vmap, torch.func.jacfwd
    o_t = torch.as_tensor(off)
    fns = NLSFunctions(
        residuals=lambda Xb: vm(t_res)(Xb, o_t),
        nlconstraints=lambda Xb: vm(t_con)(Xb, o_t),
        jac_res=lambda Xb: vm(jf(t_res))(Xb, o_t),
        jac_nlcons=lambda Xb: vm(jf(t_con))(Xb, o_t),
    )
    return X, off, j_res, j_con, fns


@pytest.mark.parametrize("method", ["qr", "normal"])
def test_least_squares_multipliers_p_positive(method):
    B = 6
    X, off, j_res, j_con, fns = _sphere_like(B)

    def one(x, o):
        return jmult.least_squares_multipliers(
            x, lambda z: j_res(z, o), jax.jacfwd(lambda z: j_res(z, o)), jax.jacfwd(j_con), method=method
        )

    jy = jax.vmap(one)(jnp.asarray(X), jnp.asarray(off))
    ty = tmult.least_squares_multipliers(torch.as_tensor(X), fns, method=method)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-12)

    # new_point on the same problem.
    y = rng.standard_normal((B, 1))
    mu = np.full(B, 10.0)

    def np_one(x, o, yy, m):
        return jal.new_point(x, yy, m, lambda z: j_res(z, o), j_con,
                             jax.jacfwd(lambda z: j_res(z, o)), jax.jacfwd(j_con))

    jr = jax.vmap(np_one)(*to_j(X, off, y, mu))
    tr = tal.new_point(*to_t(X, y, mu), fns)
    for a, bb in zip(tr[:5], jr[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL)
    np.testing.assert_allclose(tr[5].J.numpy(), np.asarray(jr[5].J), **TOL)


@pytest.mark.parametrize("maker", [batched_polys, hs48_polys], ids=["random", "hs48"])
def test_projection_polyhedron_cold_and_warm(maker):
    A, b, xl, xu, _ = maker()
    B, m, n = A.shape
    x = rng.standard_normal((B, n)) * 2.0
    jp, tp = jpoly(A, b, xl, xu), tpoly(A, b, xl, xu)
    jv, jlam = jax.vmap(lambda p, z: jpp.projection_polyhedron(p, z, return_lam=True), in_axes=(POLY_AXES, 0))(jp, jnp.asarray(x))
    tv, tlam, tit = tpp.projection_polyhedron(tp, torch.as_tensor(x), return_lam=True, return_iters=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-8, atol=1e-9)
    assert (tit.numpy() >= 1).all()
    # Warm start from a perturbed dual (exercises the restart machinery).
    lam0 = np.asarray(jlam) + rng.standard_normal((B, m))
    jw = jax.vmap(lambda p, z, l0: jpp.projection_polyhedron(p, z, lam0=l0), in_axes=(POLY_AXES, 0, 0))(jp, jnp.asarray(x), jnp.asarray(lam0))
    tw = tpp.projection_polyhedron(tp, torch.as_tensor(x), lam0=torch.as_tensor(lam0))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10, atol=1e-10)
    # Criticality measure, and the m == 0 (box only) case.
    g = rng.standard_normal((B, n))
    xf = np.clip(x, xl, xu)
    jcm = jax.vmap(jpp.criticality_measure_polyhedron, in_axes=(POLY_AXES, 0, 0))(jp, jnp.asarray(xf), jnp.asarray(g))
    tcm = tpp.criticality_measure_polyhedron(tp, torch.as_tensor(xf), torch.as_tensor(g))
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=1e-9, atol=1e-10)
    box = tpoly(np.zeros((B, 0, n)), np.zeros((B, 0)), xl, xu)
    np.testing.assert_array_equal(tpp.projection_polyhedron(box, torch.as_tensor(x)).numpy(), np.clip(x, xl, xu))


@pytest.mark.parametrize("threshold", [32, 0], ids=["breakpoint_walk", "projected_search"])
def test_inner_step_matches(threshold):
    # One inner step (Cauchy step + minor iterations with projected CG) on
    # random instances; threshold 0 takes the projected-search Cauchy step.
    A, b, xl, xu, x = batched_polys(B=6, n=6, m=1, width=0.5)
    B, m, n = A.shape
    d = 9
    J = rng.standard_normal((B, d, n))
    g = rng.standard_normal((B, n)) * 3.0
    delta = np.full(B, 0.4)
    jp, tp = jpoly(A, b, xl, xu), tpoly(A, b, xl, xu)
    jopts = JOptions(projected_cauchy_threshold=threshold)
    topts = SolverOptions(projected_cauchy_threshold=threshold)
    atol = float(np.sqrt(np.finfo(np.float64).eps))

    def one(x_, g_, J_, p_, d_):
        H = jal.AlHessian(J_, jnp.zeros((0, n)), jnp.asarray(1.0))
        return jinner.inner_step(x_, g_, H, p_, d_, jopts, atol)

    js, jpred, jaset, jst = jax.vmap(one, in_axes=(0, 0, 0, POLY_AXES, 0))(*to_j(x, g, J), jp, jnp.asarray(delta))
    tH = tal.AlHessian(torch.as_tensor(J), torch.zeros((B, 0, n), dtype=torch.float64), torch.ones(B, dtype=torch.float64))
    ts, tpred, taset, tst = tinner.inner_step(*to_t(x, g), tH, tp, torch.as_tensor(delta), topts, atol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(taset.fixed.numpy(), np.asarray(jaset.fixed))
    np.testing.assert_array_equal(tst.minor_iters.numpy(), np.asarray(jst.minor_iters))
    np.testing.assert_array_equal(tst.cg_iters.numpy(), np.asarray(jst.cg_iters))
