"""The port's single-instance entry points (`solve`, `tralcnllss`,
`Problem`) against the JAX package's, on the cases of
`tests/test_outer_e2e.py`.

Both sides get the same numbers (Python constants and numpy arrays); each
problem is written once with `jnp` and once with `torch`.  Tolerances, all
float64 on the CPU: x and y within 1e-7 of the JAX result, and
`converged`, `status`, `mu` and the outer iteration count equal; the
sphere fixture also passes the reference's own three assertions
(‖c‖ < sqrt(eps), polyhedral feasibility, exact-projection KKT measure
< 1e-7).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import benlsip_tpu as bj
import benlsip_tpu_torch as bt
from benlsip_tpu.problems import sphere_regression as j_sr
from benlsip_tpu_torch._device import as_tensor, resolve_device
from benlsip_tpu_torch.problems import sphere_regression as t_sr

torch.set_num_threads(2)
ATOL = 1e-7
SPHERE_OPTS = dict(max_outer_iter=100, max_inner_iter=250)
T_BOUND = np.array([1.5, -0.5, 0.3])


def _rosen(np_):
    return lambda x: np_.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


# name -> (JAX problem, port problem, x0, options, expected x or None)
CASES = {
    "sphere_analytic": (lambda: j_sr.make_problem(), lambda: t_sr.make_problem(), [1.0, 0.5, 1.5], SPHERE_OPTS, None),
    "sphere_autodiff": (
        lambda: j_sr.make_problem(analytic_jacobians=False), lambda: t_sr.make_problem(analytic_jacobians=False),
        [1.0, 0.5, 1.5], SPHERE_OPTS, None,
    ),
    "bound_only": (
        lambda: bj.Problem(residuals=lambda x: x - jnp.asarray(T_BOUND), xl=jnp.zeros(3), xu=jnp.ones(3)),
        lambda: bt.Problem(residuals=lambda x: x - torch.as_tensor(T_BOUND), xl=np.zeros(3), xu=np.ones(3)),
        [0.5, 0.5, 0.5], {}, [1.0, 0.0, 0.3],
    ),
    "unconstrained_gauss_newton": (
        lambda: bj.Problem(residuals=_rosen(jnp)), lambda: bt.Problem(residuals=_rosen(torch)),
        [-1.2, 1.0], {}, [1.0, 1.0],
    ),
    "linear_equality_only": (
        lambda: bj.Problem(residuals=lambda x: x, A=jnp.ones((1, 4)), b=jnp.ones((1,))),
        lambda: bt.Problem(residuals=lambda x: x, A=np.ones((1, 4)), b=[1.0]),
        [1.0, 0.0, 0.0, 0.0], {}, [0.25] * 4,
    ),
}


def _assert_same_solve(got, want):
    (xt, yt, it), (xj, yj, ij) = got, want
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=ATOL)
    assert yt.shape == np.asarray(yj).shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    assert bool(it.converged) == bool(ij.converged)
    assert int(it.status) == int(ij.status)
    assert float(it.mu) == float(ij.mu)
    assert int(it.outer_iters) == int(ij.outer_iters)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name):
    j_problem, t_problem, x0, opts, expect = CASES[name]
    want = bj.solve(j_problem(), jnp.asarray(x0), bj.SolverOptions(**opts))
    got = bt.solve(t_problem(), torch.tensor(x0, dtype=torch.float64), bt.SolverOptions(**opts))
    _assert_same_solve(got, want)
    x, y, info = got
    assert bool(info.converged) and x.dtype == torch.float64
    # SolveInfo of one instance: 0-dim tensors, read as in the JAX package.
    assert all(f.ndim == 0 for f in info) and set(info._fields) == set(want[2]._fields)
    if expect is not None:
        np.testing.assert_allclose(x.numpy(), expect, atol=1e-6)
    if name == "bound_only":
        assert y.shape == (0,)


def test_sphere_regression_reference_assertions():
    problem = t_sr.make_problem()
    x, y, info = bt.solve(problem, t_sr.x0(device="cpu"), bt.SolverOptions(**SPHERE_OPTS))
    assert float(torch.linalg.vector_norm(t_sr.nlconstraints(x))) < float(np.sqrt(np.finfo(np.float64).eps))
    fns, poly = problem.build(3, torch.float64, "cpu")
    assert bool(bt.is_feasible(poly, x[None])[0])
    # KKT via the exact-projection oracle.
    grad_lag = t_sr.jac_res(x).T @ t_sr.residuals(x) + t_sr.jac_nlcons(x).T @ y
    p = bt.projection_polyhedron(poly, (x - grad_lag)[None])[0]
    assert float(torch.linalg.vector_norm(x - p)) < 1e-7
    assert bool(info.converged)
    # The fixture's callables are the JAX package's, value for value.
    xn = np.array([0.3, -0.7, 1.1])
    for f in ("residuals", "jac_res", "nlconstraints", "jac_nlcons"):
        np.testing.assert_allclose(
            getattr(t_sr, f)(torch.as_tensor(xn)).numpy(), np.asarray(getattr(j_sr, f)(jnp.asarray(xn))), rtol=0, atol=1e-14)
    # build() gives batched callables and a batch of one.
    X = torch.as_tensor(xn)[None].expand(4, 3)
    assert fns.residuals(X).shape == (4, 4) and fns.jac_res(X).shape == (4, 4, 3)
    assert fns.nlconstraints(X).shape == (4, 1) and fns.jac_nlcons(X).shape == (4, 1, 3)
    assert [f.shape for f in poly] == [(1, 1, 3), (1, 1), (1, 3), (1, 3)]


def test_tralcnllss_matches_jax():
    data = ([[1.0, 2.0, -1.0]], [0.5], [-2.0, -1.5, 0.0], [2.0, 1.5, 2.0])
    want = bj.tralcnllss(
        j_sr.x0(), j_sr.residuals, j_sr.jac_res, j_sr.nlconstraints, j_sr.jac_nlcons,
        *map(jnp.asarray, data), **SPHERE_OPTS,
    )
    got = bt.tralcnllss(
        t_sr.x0(device="cpu"), t_sr.residuals, t_sr.jac_res, t_sr.nlconstraints, t_sr.jac_nlcons,
        *map(np.asarray, data), **SPHERE_OPTS,
    )
    _assert_same_solve(got, want)
    assert float(torch.linalg.vector_norm(t_sr.nlconstraints(got[0]))) < 1.5e-8 and bool(got[2].converged)
    # The hyperparameters go by keyword, as in the reference; an unknown one raises.
    with pytest.raises(TypeError):
        bt.tralcnllss(t_sr.x0(device="cpu"), t_sr.residuals, t_sr.jac_res, t_sr.nlconstraints, t_sr.jac_nlcons, *data, no_such_knob=1)


def test_warm_start_multipliers_match_jax():
    opts_j, opts_t = bj.SolverOptions(**SPHERE_OPTS), bt.SolverOptions(**SPHERE_OPTS)
    xj, yj, _ = bj.solve(j_sr.make_problem(), j_sr.x0(), opts_j)
    want = bj.solve(j_sr.make_problem(), j_sr.x0(), opts_j, y0=yj)
    x_c, y_c, info_c = bt.solve(t_sr.make_problem(), t_sr.x0(device="cpu"), opts_t)
    got = bt.solve(t_sr.make_problem(), t_sr.x0(device="cpu"), opts_t, y0=y_c)
    _assert_same_solve(got, want)
    x_w, _, info_w = got
    assert bool(info_c.converged) and bool(info_w.converged)
    np.testing.assert_allclose(x_w.numpy(), x_c.numpy(), rtol=1e-7, atol=1e-9)
    assert int(info_w.outer_iters) <= int(info_c.outer_iters)
    # y0 as a list, on the device of x0.
    x_l, _, _ = bt.solve(t_sr.make_problem(), t_sr.x0(device="cpu"), opts_t, y0=y_c.tolist())
    np.testing.assert_array_equal(x_l.numpy(), x_w.numpy())


@pytest.mark.parametrize("x0", [[1.0, 0.5, 1.5], np.array([1.0, 0.5, 1.5]), (1, 0.5, 1.5)], ids=["list", "numpy", "tuple"])
def test_solve_takes_non_tensor_x0_on_named_device(x0):
    want, _, _ = bt.solve(t_sr.make_problem(), t_sr.x0(device="cpu"), bt.SolverOptions(**SPHERE_OPTS))
    x, _, info = bt.solve(t_sr.make_problem(), x0, bt.SolverOptions(**SPHERE_OPTS), device="cpu")
    assert x.dtype == torch.float64 and x.device.type == "cpu" and bool(info.converged)
    np.testing.assert_array_equal(x.numpy(), want.numpy())


def test_float32_solve_keeps_float32():
    # Autodiff Jacobians of `x[0] - 1.5`-style residuals stay float32.
    x, y, info = bt.solve(t_sr.make_problem(analytic_jacobians=False), t_sr.x0(torch.float32, "cpu"),
                          bt.SolverOptions(**SPHERE_OPTS))
    assert x.dtype == y.dtype == info.pix.dtype == torch.float32 and bool(info.converged)
    np.testing.assert_allclose(x.numpy(), [1.3747, 0.0876, 1.0500], atol=2e-4)


def test_verbose_keeps_raising():
    with pytest.raises(NotImplementedError):
        bt.solve(t_sr.make_problem(), t_sr.x0(device="cpu"), bt.SolverOptions(verbose=True))


def test_device_none_is_the_card_and_raises_without_one():
    # This machine has no CUDA device: every entry point that creates
    # tensors from non-tensor input raises instead of carrying on on the CPU.
    from benlsip_tpu_torch import interop
    from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_classic_battery
    from benlsip_tpu_torch.problems import classic, generators, hs48, rosenbrock

    assert not torch.cuda.is_available()
    assert resolve_device("cpu") == torch.device("cpu") and resolve_device(torch.device("cuda:1")).index == 1
    ros = _rosen(torch)
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "as_tensor": lambda: as_tensor([1.0]),
        "solve": lambda: bt.solve(t_sr.make_problem(), [1.0, 0.5, 1.5]),
        "tralcnllss": lambda: bt.tralcnllss([1.0, 0.5, 1.5], t_sr.residuals, t_sr.jac_res, t_sr.nlconstraints,
                                            t_sr.jac_nlcons, t_sr.A, t_sr.b, t_sr.xl, t_sr.xu),
        "least_squares": lambda: bt.least_squares(ros, [0, 0]),
        "solve_qp": lambda: bt.solve_qp(np.eye(2), np.ones(2)),
        "with_inequalities": lambda: bt.with_inequalities(bt.Problem(residuals=ros), [0.0, 0.0], G=[[1.0, 1.0]], h=[1.0]),
        "sphere_regression.x0": lambda: t_sr.x0(),
        "hs48.x0": lambda: hs48.x0(),
        "hs48.x_star": lambda: hs48.x_star(),
        "rosenbrock.x0": lambda: rosenbrock.x0(),
        "classic x0": lambda: classic.REGISTRY["hs6"].x0(),
        "exp_fit_family": lambda: generators.exp_fit_family(2, d=4),
        "sphere_family": lambda: generators.sphere_family(2),
        "dense_quadratic_family": lambda: generators.dense_quadratic_family(2, n=4, d=8, m=1),
        "problem_from_numpy": lambda: interop.problem_from_numpy(np.ones((1, 2)), np.ones(1), None, None, False, ros),
        "theta_from_numpy": lambda: interop.theta_from_numpy({"y": np.ones(3)}),
        "kkt_check_classic_battery": lambda: kkt_check_classic_battery(),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
            call()
    # Handed tensors, the same entry points run on the tensors' device.
    x, _, info = bt.solve(bt.Problem(residuals=ros), torch.tensor([-1.2, 1.0], dtype=torch.float64))
    assert x.device.type == "cpu" and bool(info.converged)
    assert bt.solve_qp(torch.eye(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64))[0].device.type == "cpu"
