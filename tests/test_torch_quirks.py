"""The reference's quirks, held in the port: the counterparts of
`tests/test_reference_quirks.py` on the port's batched `solver/inner`,
`solver/cg`, `solver/subproblem` and `solver/outer` functions at B = 1.
Each asserts the documented *intent* (what users observe), and where the
JAX package returns numbers the port's agree with them.
"""
import numpy as np
import jax.numpy as jnp
import torch

import benlsip_tpu_torch as bt
from benlsip_tpu_torch.ops.al import AlHessian
from benlsip_tpu_torch.ops.constraints import Polyhedron, make_active_set, step_active_bounds
from benlsip_tpu_torch.solver.cg import projected_cg
from benlsip_tpu_torch.solver.inner import cauchy_step, inner_step, minor_iterate
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.status import CG_MAX_ITER, CG_SOLVED
from benlsip_tpu_torch.solver.subproblem import update_tr

torch.set_num_threads(2)
f64 = torch.float64


def t(a):
    """A batch of one from plain numbers."""
    return torch.as_tensor(np.array(a, dtype=np.float64))[None]


def box_poly(n, xl, xu, A=None, b=None):
    A = np.zeros((0, n)) if A is None else A
    b = np.zeros(A.shape[0]) if b is None else b
    return Polyhedron(A=t(A), b=t(b), xl=t(np.broadcast_to(xl, (n,))), xu=t(np.broadcast_to(xu, (n,))))


def identity_hessian(n):
    return AlHessian(t(np.eye(n)), torch.zeros((1, 0, n), dtype=f64), torch.ones(1, dtype=f64))


def test_quirk1_minor_budget_clamped_nonnegative():
    # Intended max(n-m-#fix, 0): inner_step with everything fixed terminates cleanly.
    n = 3
    poly = box_poly(n, 0.0, 0.0, A=np.array([[1.0, 0, 0], [0, 1.0, 0]]))   # degenerate box
    s, pred, aset, stats = inner_step(
        t(np.zeros(n)), t(np.ones(n)), identity_hessian(n), poly, torch.ones(1, dtype=f64), SolverOptions(), 1e-8
    )
    assert s.shape == (1, n) and bool((s == 0.0).all())
    assert int(stats.minor_iters[0]) == 0 and float(pred[0]) == 0.0


def test_quirk4_cg_status_never_undefined():
    # Every exit path maps to a code: a zero-dimensional tangent space
    # reports CG_MAX_ITER or CG_SOLVED.
    n = 2
    poly = box_poly(n, -1.0, 1.0, A=np.eye(2))
    aset = make_active_set(poly, torch.zeros((1, n), dtype=torch.bool))
    w, status, iters = projected_cg(t(np.ones(n)), identity_hessian(n), t([-1.0, -1.0]), t([1.0, 1.0]), poly, aset, 0.1)
    assert status.dtype == torch.int32 and int(status[0]) in (CG_MAX_ITER, CG_SOLVED)
    assert bool((w == 0.0).all()) and int(iters[0]) == 0


def test_quirk7_tr_ratio_sign_convention():
    # rho positive-good; NaN rho (0/0) keeps the radius.
    d = torch.ones(1, dtype=f64)
    for rho, want in ((0.9, 2.0), (0.1, 0.0625), (0.5, 1.0), (float("nan"), 1.0)):
        assert float(update_tr(d, torch.full((1,), rho, dtype=f64), 0.25, 0.75, 0.0625, 2.0)[0]) == want
    # Per lane in one call.
    rho = torch.tensor([0.9, 0.1, 0.5, float("nan")], dtype=f64)
    assert update_tr(torch.ones(4, dtype=f64), rho, 0.25, 0.75, 0.0625, 2.0).tolist() == [2.0, 0.0625, 1.0, 1.0]


def test_quirk6_empty_constraint_blocks_supported():
    # All four combinations of (linear, nonlinear) constraint blocks solve,
    # at the JAX package's solutions.
    import benlsip_tpu as bj

    tt = np.array([0.3, -0.2])
    for with_lin in (False, True):
        for with_nl in (False, True):
            make = lambda mod, np_: mod.Problem(
                residuals=lambda x: x - np_.asarray(tt),
                nlconstraints=(lambda x: np_.stack([x[0] - x[1] - 0.5])) if with_nl else None,
                A=np.ones((1, 2)) if with_lin else None,
                b=np.array([0.1]) if with_lin else None,
                xl=np.full(2, -1.0), xu=np.full(2, 1.0),
            )
            x, y, info = bt.solve(make(bt, torch), torch.zeros(2, dtype=f64))
            xj, yj, ij = bj.solve(make(bj, jnp), jnp.zeros(2))
            assert bool(info.converged) and bool(ij.converged), (with_lin, with_nl)
            assert y.shape == (int(with_nl),)
            np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-7)


def test_quirk5_no_side_effect_logging_by_default(tmp_path, capsys, monkeypatch):
    # Default runs produce no log output and write no file.
    from benlsip_tpu_torch.problems import sphere_regression as sr

    monkeypatch.chdir(tmp_path)
    bt.solve(sr.make_problem(), sr.x0(device="cpu"), SolverOptions(max_outer_iter=50, max_inner_iter=150))
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""
    assert list(tmp_path.iterdir()) == []


def test_quirk2_cauchy_interior_minimum_stops_before_breakpoint():
    n = 2
    H = identity_hessian(n)
    g = t([1.0, 0.5])
    delta = torch.full((1,), 5.0, dtype=f64)
    # Interior minimum: delta_t = 1 < theta = 10, so s = -g exactly, no bound activated.
    s, aset = cauchy_step(t(np.zeros(n)), g, H, box_poly(n, -10.0, 10.0), delta, 1e-10)
    np.testing.assert_allclose(s[0].numpy(), [-1.0, -0.5], atol=1e-12)
    assert not bool(aset.fixed.any())
    # Breakpoint before the minimizer: coord 0's lower bound at -0.3 cuts
    # the first segment; the walk clamps coord 0, re-projects, and goes on
    # to the constrained minimizer (-0.3, -0.5).
    s2, aset2 = cauchy_step(t(np.zeros(n)), g, H, box_poly(n, np.array([-0.3, -10.0]), 10.0), delta, 1e-10)
    np.testing.assert_allclose(s2[0].numpy(), [-0.3, -0.5], atol=1e-10)
    assert aset2.fixed[0].tolist() == [True, False]


def test_quirk3_minor_loop_box_binds_free_variables():
    # The remaining TR/bound gap binds the FREE variables of the minor step.
    n = 2
    poly = box_poly(n, -10.0, np.array([0.1, 10.0]))
    aset = make_active_set(poly, torch.zeros((1, n), dtype=torch.bool))
    x = s = t(np.zeros(n))
    g_minor = t([-5.0, 0.0])   # unconstrained CG solution w = (5, 0)
    w, status, _ = minor_iterate(x, s, g_minor, identity_hessian(n), poly, aset, torch.full((1,), 5.0, dtype=f64), 0.1)
    assert float(w[0, 0]) <= 0.1 + 1e-9
    assert bool(((x + s + w) <= poly.xu + 1e-9).all())


def test_quirk8_rejected_subproblem_bookkeeping():
    # On a rejected subproblem (feas > eta) the iterate and multipliers are
    # UNCHANGED, the subproblem cost is paid, mu escalates by tau, and the
    # tolerances reset against the NEW mu.
    from benlsip_tpu_torch.solver.outer import default_atol, outer_body, outer_init

    # min (x-2)^2/2 s.t. x = 0: at mu = 10 the AL minimizer has
    # |c(x)| ~ 0.09 >> eta, forcing the reject branch.
    eye = lambda X: torch.ones((X.shape[0], 1, 1), dtype=X.dtype)
    fns = bt.NLSFunctions(residuals=lambda X: X - 2.0, nlconstraints=lambda X: X, jac_res=eye, jac_nlcons=eye)
    poly = box_poly(1, -10.0, 10.0)
    opts = SolverOptions(eta0=1e-12, feas_tol=1e-12, crit_tol=1e-10)
    c0 = outer_init(fns, poly, torch.ones((1, 1), dtype=f64), opts)
    c1 = outer_body(fns, poly, opts, default_atol(f64), c0)
    assert not bool(c1.critical[0])
    assert torch.equal(c1.x, c0.x) and torch.equal(c1.y, c0.y)
    assert float(c1.mu[0]) == float(c0.mu[0]) * opts.tau
    np.testing.assert_allclose(float(c1.omega[0]), opts.omega0 / float(c1.mu[0]) ** opts.k_crit)
    np.testing.assert_allclose(float(c1.eta[0]), opts.eta0 / float(c1.mu[0]) ** opts.k_feas)
    assert int(c1.inner_total[0]) > 0 and np.isfinite(float(c1.pix[0]))


def test_quirk9_step_active_bounds_uses_tr_clamped_lower():
    # A step reaching the TR face (-delta) is flagged active even when the
    # actual bound is far away; a mid-box step is not.
    n = 2
    x, delta = t(np.zeros(n)), torch.ones(1, dtype=f64)
    mask = step_active_bounds(box_poly(n, -10.0, 10.0), x, t([-1.0, 0.2]), delta, 1e-10)
    assert mask[0].tolist() == [True, False]
    # Bound closer than the radius: the box edge is the bound itself.
    mask2 = step_active_bounds(box_poly(n, np.array([-0.5, -10.0]), 10.0), x, t([-0.5, 0.2]), delta, 1e-10)
    assert mask2[0].tolist() == [True, False]
