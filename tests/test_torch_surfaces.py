"""The port's remaining public surfaces — `solve_qp`, `with_inequalities`,
`least_squares` — against the JAX package's results and against the JAX
tests' own oracles (`tests/test_qp.py`, `tests/test_transforms.py`,
`tests/test_compat.py`): dense numpy KKT solves, analytic minimizers,
scipy.

Float64 on the CPU; every problem is written once with `jnp` and once with
`torch` from the same numpy numbers.  Unless a case says otherwise the
port's x is within 1e-7 of the JAX package's and `converged` is equal; the
oracle tolerances are those of the JAX tests.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import benlsip_tpu as bj
import benlsip_tpu_torch as bt

torch.set_num_threads(2)
VS_JAX = dict(rtol=0, atol=1e-7)
T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))


# ----------------------------------------------------------------- solve_qp

def _random_qp(rng, n, m, kappa=10.0):
    M = rng.standard_normal((n, n))
    U, _ = np.linalg.qr(M)
    s = np.logspace(0, -np.log10(kappa), n)
    return (U * s) @ U.T, rng.standard_normal(n), rng.standard_normal((m, n)), rng.standard_normal(m)


def _kkt_solve(Q, c, A, b):
    n, m = Q.shape[0], A.shape[0]
    K = np.block([[Q, A.T], [A, np.zeros((m, m))]])
    sol = np.linalg.solve(K, np.concatenate([-c, b]))
    return sol[:n], sol[n:]


def test_equality_qp_matches_kkt_and_jax():
    Q, c, A, b = _random_qp(np.random.default_rng(0), 24, 5)
    x, nu, info = bt.solve_qp(Q, c, A, b, device="cpu")
    assert bool(info.converged) and isinstance(info, bt.QPInfo) and all(f.ndim == 0 for f in info)
    x_ref, nu_ref = _kkt_solve(Q, c, A, b)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(nu.numpy(), nu_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-9)
    xj, nuj, ij = bj.solve_qp(*map(jnp.asarray, (Q, c, A, b)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VS_JAX)
    np.testing.assert_allclose(nu.numpy(), np.asarray(nuj), **VS_JAX)
    assert int(info.status) == int(ij.status) and int(info.iters) == int(ij.iters)
    # The reference's sign convention: it minimizes ½xᵀHx − cᵀx, so -c here.
    x_neg, _, _ = bt.solve_qp(T(Q), T(-c), T(A), T(b))
    np.testing.assert_allclose(x_neg.numpy(), _kkt_solve(Q, -c, A, b)[0], rtol=1e-6, atol=1e-8)


def test_unconstrained_qp():
    Q, c, _, _ = _random_qp(np.random.default_rng(1), 16, 0)
    x, nu, info = bt.solve_qp(T(Q), T(c))
    assert bool(info.converged) and nu.shape == (0,)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(Q, -c), rtol=1e-6, atol=1e-8)
    xj, _, _ = bj.solve_qp(jnp.asarray(Q), jnp.asarray(c))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VS_JAX)


def test_equality_qp_batched():
    """Batch-first where the JAX package is vmappable: (B, ...) operands."""
    rng = np.random.default_rng(2)
    B, n, m = 8, 12, 3
    Qb, cb, Ab, bb = map(np.stack, zip(*[_random_qp(rng, n, m) for _ in range(B)]))
    X, NU, info = bt.solve_qp(T(Qb), T(cb), T(Ab), T(bb))
    assert X.shape == (B, n) and NU.shape == (B, m) and info.converged.shape == (B,) and bool(info.converged.all())
    Xj, _, ij = jax.jit(jax.vmap(lambda Q, c, A, b: bj.solve_qp(Q, c, A, b)))(*map(jnp.asarray, (Qb, cb, Ab, bb)))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), **VS_JAX)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(ij.iters))
    for i in range(B):
        np.testing.assert_allclose(X[i].numpy(), _kkt_solve(Qb[i], cb[i], Ab[i], bb[i])[0], rtol=1e-5, atol=1e-7)
    # A shared Q and A under per-instance c and b.
    Xs, _, info_s = bt.solve_qp(T(Qb[0]), T(cb), T(Ab[0]), T(bb))
    assert bool(info_s.converged.all())
    for i in range(B):
        np.testing.assert_allclose(Xs[i].numpy(), _kkt_solve(Qb[0], cb[i], Ab[0], bb[i])[0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["box_analytic", "box_equality", "box_equality_batched"])
def test_box_qp(case):
    if case == "box_analytic":
        # min ½‖x − t‖² with box: the solution is clip(t), the projection.
        t = np.array([2.0, -3.0, 0.25])
        x, nu, info = bt.solve_qp(np.eye(3), -t, xl=-1.0, xu=1.0, device="cpu")
        assert bool(info.converged) and nu.shape == (0,)
        np.testing.assert_allclose(x.numpy(), [1.0, -1.0, 0.25], atol=1e-8)
        xj, _, _ = bj.solve_qp(jnp.eye(3), jnp.asarray(-t), xl=-1.0, xu=1.0)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VS_JAX)
        return
    n, m = 6, 2
    Q, c, A, b = _random_qp(np.random.default_rng(3), n, m, kappa=5.0)
    b = 0.1 * b   # feasible for the box
    xl, xu = -0.4, 0.4
    if case == "box_equality":
        x, nu, info = bt.solve_qp(T(Q), T(c), T(A), T(b), xl=xl, xu=xu)
        xj, nuj, ij = bj.solve_qp(*map(jnp.asarray, (Q, c, A, b)), xl=xl, xu=xu)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VS_JAX)
        np.testing.assert_allclose(nu.numpy(), np.asarray(nuj), rtol=0, atol=1e-6)
        assert float(info.stationarity) < 1e-6
        xs, cs = [x.numpy()], [c]
    else:
        cs = [c, -c, 0.5 * c]
        X, NU, info = bt.solve_qp(T(Q), T(np.stack(cs)), T(A), T(b), xl=xl, xu=xu)
        assert X.shape == (3, n) and NU.shape == (3, m) and info.converged.shape == (3,)
        xs = list(X.numpy())
    assert bool(info.converged.all()), info
    # KKT directly: feasibility, free-coordinate stationarity, dual signs.
    for xh, ch in zip(xs, cs):
        assert np.all(xh >= xl - 1e-8) and np.all(xh <= xu + 1e-8)
        np.testing.assert_allclose(A @ xh, b, atol=1e-8)
        g = Q @ xh + ch
        free = (xh > xl + 1e-6) & (xh < xu - 1e-6)
        nu_h, *_ = np.linalg.lstsq(A[:, free].T, -g[free], rcond=None)
        gL = g + A.T @ nu_h
        assert np.linalg.norm(gL[free]) < 1e-6
        assert np.all(gL[xh <= xl + 1e-6] >= -1e-6) and np.all(gL[xh >= xu - 1e-6] <= 1e-6)


# -------------------------------------------------------- with_inequalities

OPTS = dict(max_outer_iter=60, max_inner_iter=200)
P_OUT = np.array([1.8, 0.6])


def _disk(np_):
    return lambda x: np_.stack([1.0 - x @ x])


def _lifted_solve(mod, prob, x0, kw):
    if mod is bt:
        lift = bt.with_inequalities(prob, T(x0), **{k: (v if callable(v) else T(v)) for k, v in kw.items()})
    else:
        lift = bj.with_inequalities(prob, jnp.asarray(x0), **{k: (v if callable(v) else jnp.asarray(v)) for k, v in kw.items()})
    z, y, info = mod.solve(lift.problem, lift.z0, mod.SolverOptions(**OPTS))
    s, t = lift.slacks(z)
    return np.asarray(lift.unlift(z)), np.asarray(s), np.asarray(t), np.asarray(y), info


def _hs15(np_):
    return dict(residuals=lambda x: np_.stack([10 * (x[1] - x[0] ** 2), 1 - x[0]])), \
        lambda x: np_.stack([x[0] * x[1] - 1.0, x[0] + x[1] ** 2])


# name -> factory(mod, np_) -> (Problem, x0, with_inequalities keywords)
def _ineq_cases():
    line = dict(G=[[1.0, 1.0]], h=[1.0])

    def linear(p):
        return lambda mod, np_: (mod.Problem(residuals=lambda x: x - np_.asarray(p)), p, line)

    def mixed(mod, np_):
        p = np.array([0.9, 0.9, 0.1])
        prob = mod.Problem(residuals=lambda x: x - np_.asarray(p), A=np_.ones((1, 3)), b=np_.asarray([1.5]),
                           xl=np_.zeros(3), xu=np_.ones(3))
        return prob, [0.4, 0.4, 0.7], dict(nl_ineq=lambda x: np_.stack([x[2] - x[0] ** 2]))

    def hs21(mod, np_):
        prob = mod.Problem(residuals=lambda x: np_.stack([np.sqrt(0.02) * x[0], np.sqrt(2.0) * x[1]]),
                           xl=np_.asarray([2.0, -50.0]), xu=np_.asarray([50.0, 50.0]))
        return prob, [-1.0, -1.0], dict(G=[[10.0, -1.0]], h=[10.0])

    def hs15(mod, np_):
        res, g = _hs15(np_)
        return mod.Problem(**res, xu=np_.asarray([0.5, np.inf])), [-2.0, 1.0], dict(nl_ineq=g)

    return {
        "linear_active": linear(np.array([0.2, 0.1])),
        "linear_inactive": linear(np.array([0.9, 0.8])),
        "nonlinear_disk": lambda mod, np_: (mod.Problem(residuals=lambda x: x - np_.asarray(P_OUT)), [0.5, 0.2], dict(nl_ineq=_disk(np_))),
        "mixed_equality_inequality_bounds": mixed,
        "hs21_linear_inequality": hs21,
        "hs15_nonlinear_inequalities": hs15,
        "scalar_constraint_promoted": lambda mod, np_: (
            mod.Problem(residuals=lambda x: x - np_.asarray(P_OUT)), [0.5, 0.2],
            dict(nl_ineq=lambda x: 1.0 - x @ x, jac_ineq=lambda x: -2.0 * x)),
    }


INEQ_CASES = _ineq_cases()


@pytest.mark.parametrize("name", sorted(INEQ_CASES))
def test_with_inequalities_matches_jax_and_ground_truth(name):
    x, s, t, y, info = _lifted_solve(bt, *INEQ_CASES[name](bt, torch))
    xj, sj, tj, yj, ij = _lifted_solve(bj, *INEQ_CASES[name](bj, jnp))
    assert bool(info.converged) and bool(ij.converged)
    for got, want in ((x, xj), (s, sj), (t, tj)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **VS_JAX)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)   # multipliers of the lifted equalities
    unit = P_OUT / np.linalg.norm(P_OUT)
    if name == "linear_active":
        p = np.array([0.2, 0.1])
        np.testing.assert_allclose(x, p + (1 - p.sum()) / 2.0, rtol=1e-7, atol=1e-8)   # projection onto x1 + x2 = 1
        np.testing.assert_allclose(t, 0.0, atol=1e-7)
    elif name == "linear_inactive":
        np.testing.assert_allclose(x, [0.9, 0.8], atol=1e-8)
        assert t[0] > 0.5   # 1.7 − 1 = 0.7 slack
    elif name == "nonlinear_disk":
        np.testing.assert_allclose(x, unit, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s, 0.0, atol=1e-6)
    elif name == "scalar_constraint_promoted":
        np.testing.assert_allclose(x, unit, rtol=1e-6, atol=1e-7)
    elif name == "hs21_linear_inequality":
        np.testing.assert_allclose(x, [2.0, 0.0], atol=1e-7)
        np.testing.assert_allclose(0.01 * x[0] ** 2 + x[1] ** 2 - 100, -99.96, atol=1e-9)
    elif name == "hs15_nonlinear_inequalities":
        np.testing.assert_allclose(x, [0.5, 2.0], atol=1e-6)
        np.testing.assert_allclose(100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2, 306.5, atol=1e-7)
    else:
        scipy_opt = pytest.importorskip("scipy.optimize")
        p = np.array([0.9, 0.9, 0.1])
        res = scipy_opt.minimize(
            lambda v: 0.5 * np.sum((v - p) ** 2), np.asarray([0.4, 0.4, 0.7]),
            constraints=[{"type": "eq", "fun": lambda v: v.sum() - 1.5},
                         {"type": "ineq", "fun": lambda v: v[2] - v[0] ** 2}],
            bounds=[(0.0, 1.0)] * 3, method="SLSQP", options={"ftol": 1e-12, "maxiter": 500},
        )
        assert res.success
        np.testing.assert_allclose(x, res.x, rtol=1e-5, atol=1e-6)


def test_batched_lifted_family():
    """The lifted problem batches like any other: per-instance targets,
    every instance converging; `unlift` and `slacks` take batched z."""
    from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem, solve_batched

    B = 8
    Pn = np.random.default_rng(0).uniform(0.5, 2.0, (B, 2))
    P_ = T(Pn)
    lift = bt.with_inequalities(bt.Problem(residuals=lambda x: x - P_[0]), P_[0], nl_ineq=_disk(torch))
    bp = BatchedProblem(
        residuals=lambda z, th: z[:2] - th["p"],
        nlconstraints=lambda z, th: torch.stack([1.0 - z[:2] @ z[:2] - z[2]]),
        A=lift.problem.A, b=lift.problem.b, xl=lift.problem.xl, xu=lift.problem.xu,
    )
    Z0 = torch.cat([P_ / torch.linalg.vector_norm(P_, dim=1, keepdim=True) * 0.5, torch.full((B, 1), 0.5, dtype=torch.float64)], dim=1)
    Z, Y, info = solve_batched(bp, {"p": P_}, Z0, bt.SolverOptions(**OPTS))
    assert bool(info.converged.all())
    nrm = np.linalg.norm(Pn, axis=1, keepdims=True)
    # ‖p‖ > 1 → projection onto the unit circle; ‖p‖ ≤ 1 → x* = p.
    np.testing.assert_allclose(lift.unlift(Z).numpy(), np.where(nrm > 1.0, Pn / nrm, Pn), rtol=1e-6, atol=1e-6)
    s, t = lift.slacks(Z)
    assert s.shape == (B, 1) and t.shape == (B, 0)
    # The lifted Problem's own batched callables agree with the hand-written family.
    fns, poly = lift.problem.build(3, torch.float64, "cpu")
    np.testing.assert_allclose(fns.nlconstraints(Z).numpy(), bp.instance_fns({"p": P_}).nlconstraints(Z).numpy(), atol=1e-14)
    assert fns.jac_nlcons(Z).shape == (B, 1, 3) and fns.jac_res(Z).shape == (B, 2, 3) and poly.A.shape == (1, 0, 3)


def test_transform_argument_guards():
    """Mis-keyed calls raise instead of silently dropping constraints, with
    the JAX package's error texts."""
    prob = bt.Problem(residuals=lambda x: x)
    z2 = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="h given without G"):
        bt.with_inequalities(prob, z2, nl_ineq=lambda x: x, h=[1.0])
    with pytest.raises(ValueError, match="jac_ineq given without nl_ineq"):
        bt.with_inequalities(prob, z2, G=np.eye(2), h=np.zeros(2), jac_ineq=lambda x: torch.eye(2))
    with pytest.raises(ValueError, match="give nl_ineq and/or"):
        bt.with_inequalities(prob, z2)
    with pytest.raises(ValueError, match="G given without h"):
        bt.with_inequalities(prob, z2, G=np.eye(2))


# ------------------------------------------------------------ least_squares

def _rosenbrock(np_):
    return lambda x: np_.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def _np_rosenbrock(v):
    return np.array([10.0 * (v[1] - v[0] ** 2), 1.0 - v[0]])


def _same_result(res, ref):
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), **VS_JAX)
    np.testing.assert_array_equal(res.active_mask.numpy(), np.asarray(ref.active_mask))
    assert (res.success, res.status, res.message) == (ref.success, ref.status, ref.message)
    assert (res.nfev, res.njev, res.nit) == (ref.nfev, ref.njev, ref.nit)
    np.testing.assert_allclose(res.cost, ref.cost, rtol=0, atol=1e-12)


def test_unbounded_rosenbrock_matches_scipy_and_jax():
    sp = pytest.importorskip("scipy.optimize")
    res = bt.least_squares(_rosenbrock(torch), T([-1.2, 1.0]))
    ref = sp.least_squares(_np_rosenbrock, [-1.2, 1.0])
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), ref.x, atol=1e-7)
    assert res.cost < 1e-14
    np.testing.assert_array_equal(res.active_mask.numpy(), 0)
    assert res.fun.shape == (2,) and res.jac.shape == (2, 2) and res.grad.shape == (2,)
    assert "OptimizeResult(success=True" in repr(res) and isinstance(res, bt.OptimizeResult)
    _same_result(res, bj.least_squares(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0])))


def test_bounded_matches_scipy_and_jax():
    """Bound binds at the solution: x1 <= 0.8 cuts the Rosenbrock valley."""
    sp = pytest.importorskip("scipy.optimize")
    bounds = ([-2.0, -2.0], [0.8, 2.0])
    res = bt.least_squares(_rosenbrock(torch), np.array([-1.2, 1.0]), bounds=bounds, device="cpu")
    ref = sp.least_squares(_np_rosenbrock, [-1.2, 1.0], bounds=bounds, xtol=1e-15, gtol=1e-12)
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), ref.x, atol=1e-6)
    assert int(res.active_mask[0]) == 1 and res.optimality < 1.5e-8   # upper bound active
    _same_result(res, bj.least_squares(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0]), bounds=bounds))


def test_args_and_explicit_jac():
    """fun(x, *args) + hand-coded jac route; linear problem, exact answer."""
    A = np.array([[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    b = np.array([2.0, 3.0, 2.0])
    res = bt.least_squares(lambda x, M, y: M @ x - y, torch.zeros(2, dtype=torch.float64),
                           jac=lambda x, M, y: M, args=(T(A), T(b)))
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-9)
    _same_result(res, bj.least_squares(lambda x, M, y: M @ x - y, jnp.zeros(2), jac=lambda x, M, y: M,
                                       args=(jnp.asarray(A), jnp.asarray(b))))


def test_equality_extension_beyond_scipy():
    """A_eq/b_eq and nl_eq — the surface scipy cannot express."""
    p = np.array([0.3, 0.9])
    res = bt.least_squares(lambda x: x - T(p), [0.0, 0.0], A_eq=[[1.0, 1.0]], b_eq=[1.0], device="cpu")
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), p + (1 - p.sum()) / 2.0, atol=1e-8)
    _same_result(res, bj.least_squares(lambda x: x - jnp.asarray(p), jnp.zeros(2),
                                       A_eq=jnp.asarray([[1.0, 1.0]]), b_eq=jnp.asarray([1.0])))
    # A nonlinear equality: the closest point of the unit circle to p.
    res = bt.least_squares(lambda x: x - T(P_OUT), T([0.5, 0.2]), nl_eq=lambda x: torch.stack([x @ x - 1.0]))
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), P_OUT / np.linalg.norm(P_OUT), atol=1e-7)


def test_integer_x0_is_cast_like_scipy():
    res = bt.least_squares(_rosenbrock(torch), [0, 0], device="cpu")
    assert res.success and res.x.dtype == torch.float64
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-7)
    assert res.nfev >= res.nit and res.njev is None
    assert bt.least_squares(_rosenbrock(torch), torch.tensor([0, 0])).x.dtype == torch.float64
    _same_result(res, bj.least_squares(_rosenbrock(jnp), [0, 0]))


def test_max_nfev_caps_both_loops():
    res = bt.least_squares(_rosenbrock(torch), T([-1.2, 1.0]), max_nfev=3)
    assert res.nfev <= 3 * 3 + 1   # product bound from the documented mapping
    _same_result(res, bj.least_squares(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0]), max_nfev=3))


def test_bounds_instance_like_scipy():
    class Bounds:  # stand-in with scipy's attribute surface
        def __init__(self, lb, ub):
            self.lb, self.ub = lb, ub

    res = bt.least_squares(_rosenbrock(torch), T([0.5, 0.5]), bounds=Bounds(0.0, 0.8))
    assert res.success
    assert float(res.x[0]) <= 0.8 + 1e-9 and float(res.x[1]) <= 0.8 + 1e-9
    _same_result(res, bj.least_squares(_rosenbrock(jnp), jnp.asarray([0.5, 0.5]), bounds=Bounds(0.0, 0.8)))
    sp = pytest.importorskip("scipy.optimize")
    res_sp = bt.least_squares(_rosenbrock(torch), T([0.5, 0.5]), bounds=sp.Bounds(0.0, 0.8))
    np.testing.assert_array_equal(res_sp.x.numpy(), res.x.numpy())


def test_status_follows_scipy_sign_convention():
    """status > 0 iff success (scipy convention); 0 = iteration limit.
    The framework's own codes stay on res.info.status."""
    ok = bt.least_squares(_rosenbrock(torch), T([-1.2, 1.0]))
    assert ok.success and ok.status > 0 and int(ok.info.status) == 1
    capped = bt.least_squares(_rosenbrock(torch), T([-1.2, 1.0]), max_nfev=1)
    ref = bj.least_squares(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0]), max_nfev=1)
    assert (capped.success, capped.status, int(capped.info.status)) == (ref.success, ref.status, int(ref.info.status))
    if not capped.success:
        assert capped.status <= 0 and int(capped.info.status) in (2, 3)
