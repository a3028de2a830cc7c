"""The port's copy of the single-core numpy baseline
(benlsip_tpu_torch/baselines/numpy_ref.py) against the JAX package's
module on the same small inputs: the same numpy operations in the same
order, so every output is equal bit for bit."""
import numpy as np
import pytest

from benlsip_tpu.baselines import numpy_ref as j_ref
from benlsip_tpu_torch.baselines import numpy_ref as t_ref
from benlsip_tpu_torch.problems.generators import blocked_hard_family, exp_fit_family


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _lsq_case(seed, n=6, d=18, m=2, B=3):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((d, n))
    A = rng.standard_normal((m, n))
    xs = rng.standard_normal((B, n))
    Y = xs @ J.T + 0.1 * rng.standard_normal((B, d))
    xl, xu = np.full(n, -0.5), np.full(n, 0.5)
    return J, Y, A, A @ np.clip(xs[0], xl, xu), xl, xu, np.zeros((B, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_matches(seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2, 5))
    xl, xu = -np.ones(5), np.ones(5)
    b = A @ rng.uniform(-0.5, 0.5, 5)
    z = 3 * rng.standard_normal(5)
    _same(t_ref.project_polyhedron_np(z, A, b, xl, xu), j_ref.project_polyhedron_np(z, A, b, xl, xu))
    _same(t_ref.project_polyhedron_np(z, np.zeros((0, 5)), np.zeros(0), xl, xu),
          j_ref.project_polyhedron_np(z, np.zeros((0, 5)), np.zeros(0), xl, xu))


def test_exp_fit_baseline_matches():
    bp, th, X0 = exp_fit_family(8, d=32, seed=7, device="cpu")
    args = (th["t"].numpy(), th["y"].numpy(), bp.A.numpy(), bp.b.numpy(), bp.xl.numpy(), bp.xu.numpy(), X0.numpy())
    got, want = t_ref.solve_exp_fit_numpy(*args), j_ref.solve_exp_fit_numpy(*args)
    _same(got, want)
    assert got[1] == 8


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_lsq_baseline_matches(seed):
    args = _lsq_case(seed)
    got = t_ref.solve_dense_lsq_numpy(*args)
    _same(got, j_ref.solve_dense_lsq_numpy(*args))
    assert got[1] == 3


@pytest.mark.parametrize("step_rule", ["boundary", "clip"])
def test_one_instance_with_a_nonlinear_constraint_matches(step_rule):
    # min ½‖x − t‖² on the unit sphere, inside a box, with x0 + x1 = 0.3.
    t = np.array([0.9, 0.2, -0.6])
    fns = (lambda x: x - t, lambda x: np.eye(3), lambda x: np.array([x @ x - 1.0]), lambda x: 2.0 * x[None, :])
    A, b = np.array([[1.0, 1.0, 0.0]]), np.array([0.3])
    xl, xu, x0 = np.full(3, -0.8), np.full(3, 0.8), np.array([0.2, 0.1, -0.5])
    got = t_ref.solve_one_numpy(*fns, A, b, xl, xu, x0, step_rule=step_rule)
    _same(got, j_ref.solve_one_numpy(*fns, A, b, xl, xu, x0, step_rule=step_rule))
    assert got[2]["converged"]


def test_family_driver_matches():
    J, Y, A, b, xl, xu, X0 = _lsq_case(3)
    make = lambda i: ((lambda x: J @ x - Y[i]), (lambda x: J), (lambda x: np.zeros(0)), (lambda x: np.zeros((0, 6))))
    got = t_ref.solve_family_numpy(make, 3, A, b, xl, xu, X0, b_per_instance=np.stack([b] * 3))
    _same(got, j_ref.solve_family_numpy(make, 3, A, b, xl, xu, X0, b_per_instance=np.stack([b] * 3)))


def test_blocked_baseline_matches():
    bp, th, x0 = blocked_hard_family(n=64, d=256, seed=1, device="cpu")
    args = tuple(np.asarray(a, np.float64) for a in (th["J"], th["y"], bp.A, bp.b, bp.xl, bp.xu, x0))
    got = t_ref.solve_blocked_numpy(*args, alpha=1.5)
    _same(got, j_ref.solve_blocked_numpy(*args, alpha=1.5))
    assert got[1]["converged"]
