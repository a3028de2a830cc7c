"""The port's classic HS/MGH battery (`benlsip_tpu_torch.problems.classic`)
against the JAX package's, entry by entry.

Float64 on the CPU.  Tolerances: the start x0 is equal and r(x0), c(x0)
agree to 1e-14 (the same formulas in another library); the port's solution
is within max(1e-7, the record's x_tol) of the JAX package's (entries whose
Jacobian is singular at the optimum pin x only to x_tol) with `converged`
equal (mgh03, which the record pins by its objective only — κ(J) ~ 1e9
along a flat valley — is compared at a relative 1e-3 in x), and it meets
the published optimum as the JAX package's own test
does: feasible, ‖c‖ < sqrt(eps), f − f* < 1e-8 + 1e-6·|f*|, ‖x − x*‖∞ <
x_tol.  HS52 / HS53 are held to the exact saddle-point solve within 1e-8.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import benlsip_tpu as bj
import benlsip_tpu_torch as bt
from benlsip_tpu.problems import classic as j_classic
from benlsip_tpu_torch.problems import classic as t_classic
from benlsip_tpu_torch.problems import hs48 as t_hs48, rosenbrock as t_ros

torch.set_num_threads(2)
FEAS_TOL = float(np.sqrt(np.finfo(np.float64).eps))
NAMES = sorted(j_classic.REGISTRY)


def _opts(mod, rec):
    if rec.options:
        return mod.SolverOptions(max_outer_iter=100, **rec.options)
    return mod.SolverOptions(max_outer_iter=100, max_inner_iter=300)


def test_registry_matches_jax_record_by_record():
    assert sorted(t_classic.REGISTRY) == NAMES and len(NAMES) == 18
    for name in NAMES:
        rj, rt = j_classic.REGISTRY[name], t_classic.REGISTRY[name]
        for f in ("name", "x_star", "f_star", "x_tol", "unconstrained", "options"):
            assert getattr(rt, f) == getattr(rj, f), (name, f)
        x0 = rt.x0(device="cpu")
        if rt.x_star is not None:
            assert len(rt.x_star) == x0.shape[0], name
        r = rt.make_problem().residuals(x0)
        assert r.ndim == 1 and r.shape[0] >= 1, name
        assert rt.x0(torch.float32, "cpu").dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_classic_problem_matches_jax(name):
    rj, rt = j_classic.REGISTRY[name], t_classic.REGISTRY[name]
    pj, pt = rj.make_problem(), rt.make_problem()
    x0j, x0t = rj.x0(), rt.x0(device="cpu")
    n = x0t.shape[0]
    np.testing.assert_array_equal(x0t.numpy(), np.asarray(x0j))
    fns_j, poly_j = pj.build(n, jnp.float64)
    fns_t, poly_t = pt.build(n, torch.float64, "cpu")
    np.testing.assert_allclose(fns_t.residuals(x0t[None])[0].numpy(), np.asarray(fns_j.residuals(x0j)), rtol=0, atol=1e-14)
    cj = np.asarray(fns_j.nlconstraints(x0j))
    ct = fns_t.nlconstraints(x0t[None])[0].numpy()
    assert ct.shape == cj.shape
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-14)
    for f in ("A", "b", "xl", "xu"):
        np.testing.assert_array_equal(getattr(poly_t, f)[0].numpy(), np.asarray(getattr(poly_j, f)))

    xj, _, ij = bj.solve(pj, x0j, _opts(bj, rj))
    x, y, info = bt.solve(pt, x0t, _opts(bt, rt))
    assert bool(info.converged) == bool(ij.converged)
    if name == "mgh03_powell_badly_scaled":
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-3, atol=0)
    else:
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=max(1e-7, rt.x_tol))

    # The published optimum, as tests/test_classic_problems.py holds the JAX package to it.
    assert bool(info.converged), f"{name}: not converged (pix={float(info.pix)})"
    assert torch.isfinite(x).all()
    assert bool(bt.is_feasible(poly_t, x[None])[0]), f"{name}: polyhedron infeasible"
    cx = fns_t.nlconstraints(x[None])[0]
    if cx.numel():
        assert float(torch.linalg.vector_norm(cx)) < FEAS_TOL
    if rt.f_star is not None:
        f = 0.5 * float((fns_t.residuals(x[None]) ** 2).sum())
        assert f - rt.f_star < 1e-8 + 1e-6 * abs(rt.f_star), f"{name}: f={f} vs f*={rt.f_star}"
    if rt.x_star is not None:
        err = float((x - torch.tensor(rt.x_star, dtype=torch.float64)).abs().max())
        assert err < rt.x_tol, f"{name}: ||x-x*||_inf={err} (tol {rt.x_tol})"


@pytest.mark.parametrize("name", ["hs52", "hs53"])
def test_linear_ls_entries_match_exact_kkt(name):
    rec = t_classic.REGISTRY[name]
    problem = rec.make_problem()
    n = rec.x0(device="cpu").shape[0]
    zero = torch.zeros(n, dtype=torch.float64)
    G = torch.func.jacfwd(problem.residuals)(zero).numpy()
    h = -problem.residuals(zero).numpy()
    A, b = np.asarray(problem.A), np.asarray(problem.b)
    m = A.shape[0]
    K = np.block([[G.T @ G, A.T], [A, np.zeros((m, m))]])
    x_exact = np.linalg.solve(K, np.concatenate([G.T @ h, b]))[:n]

    x, _, info = bt.solve(problem, rec.x0(device="cpu"), bt.SolverOptions(max_outer_iter=100, max_inner_iter=300))
    assert bool(info.converged)
    np.testing.assert_allclose(x.numpy(), x_exact, atol=1e-8)
    if name == "hs53":
        assert np.max(np.abs(x_exact)) < 10.0   # the ±10 box is inactive at the optimum


@pytest.mark.parametrize("fixture", ["hs48", "rosenbrock_bounded", "rosenbrock_free", "rosenbrock_chained"])
def test_small_fixtures_match_jax(fixture):
    from benlsip_tpu.problems import hs48 as j_hs48, rosenbrock as j_ros

    pj, pt, x0j, x0t, x_star = {
        "hs48": lambda: (j_hs48.make_problem(), t_hs48.make_problem(), j_hs48.x0(), t_hs48.x0(device="cpu"),
                         t_hs48.x_star(device="cpu").numpy()),
        "rosenbrock_bounded": lambda: (j_ros.make_problem(True), t_ros.make_problem(True), j_ros.x0(), t_ros.x0(device="cpu"), np.ones(2)),
        "rosenbrock_free": lambda: (j_ros.make_problem(False), t_ros.make_problem(False), j_ros.x0(), t_ros.x0(device="cpu"), np.ones(2)),
        "rosenbrock_chained": lambda: (j_ros.make_chained(5), t_ros.make_chained(5), jnp.full((5,), -0.5),
                                       torch.full((5,), -0.5, dtype=torch.float64), np.ones(5)),
    }[fixture]()
    np.testing.assert_array_equal(x0t.numpy(), np.asarray(x0j))
    np.testing.assert_allclose(pt.residuals(x0t).numpy(), np.asarray(pj.residuals(x0j)), rtol=0, atol=1e-14)
    xj, _, ij = bj.solve(pj, x0j)
    x, _, info = bt.solve(pt, x0t)
    assert bool(info.converged) and bool(ij.converged)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(x.numpy(), x_star, atol=1e-6)
