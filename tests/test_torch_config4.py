"""BASELINE config 4 of the port: `blocked_hard_family` and the blocked
solve against the JAX package, and the operator routes under an axis.

Tolerances: the generated arrays are equal bit for bit (same numpy recipe).
The n=256, d=512 solve through `solve_large_blocked_family` on a one-block
mesh: float32 at the default tolerances to 1e-4 in x (two float32
trajectories that stop at pix ≤ sqrt(eps(f32)) = 3.45e-4 from different
roundings; they agree to 2.8e-5 here), float64 at crit_tol 1e-5 to 1e-8
with the same iteration counts (5e-10 here; at sqrt(eps(f64)) this
instance runs to the outer cap in both packages, on different
trajectories).  The port's numpy KKT oracle passes at the grade each
solve asked for.
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benlsip_tpu.dist.mesh import make_mesh as j_make_mesh  # noqa: E402
from benlsip_tpu.dist.sharded import solve_large_blocked_family as j_solve  # noqa: E402
from benlsip_tpu.problems.generators import blocked_hard_family as j_family  # noqa: E402
from benlsip_tpu.solver.options import SolverOptions as JOptions  # noqa: E402
from benlsip_tpu.solver.subproblem import resolve_operator_route as j_route  # noqa: E402
from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_point  # noqa: E402
from benlsip_tpu_torch.dist import collectives as col  # noqa: E402
from benlsip_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from benlsip_tpu_torch.dist.sharded import solve_large_blocked_family  # noqa: E402
from benlsip_tpu_torch.ops import al as tal  # noqa: E402
from benlsip_tpu_torch.problems.generators import blocked_hard_family  # noqa: E402
from benlsip_tpu_torch.solver.options import SolverOptions  # noqa: E402
from benlsip_tpu_torch.solver.subproblem import resolve_operator_route  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}
ALPHA = 1.5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blocked_hard_family_bit_identical(dtype):
    td, jd = DTYPES[dtype]
    bp, th, x0 = blocked_hard_family(n=64, d=128, seed=4, dtype=td, device="cpu")
    jbp, jth, jx0 = j_family(n=64, d=128, seed=4, dtype=jd)
    for got, want in ((th["J"], jth["J"]), (th["y"], jth["y"]), (bp.A, jbp.A), (bp.b, jbp.b),
                      (bp.xl, jbp.xl), (bp.xu, jbp.xu), (x0, jx0)):
        assert got.dtype == td
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The callables at a point inside the box, per instance (x (n,)).
    x = torch.linspace(-0.7, 0.7, 64, dtype=td)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bp.residuals(x, th).numpy(), np.asarray(jbp.residuals(jnp.asarray(x.numpy()), jth)), **tol)
    np.testing.assert_allclose(bp.jac_res(x, th).numpy(), np.asarray(jbp.jac_res(jnp.asarray(x.numpy()), jth)), **tol)


def test_blocked_hard_family_keeps_the_batch_axis_a_view():
    """The solver lifts theta to a batch of one with `unsqueeze`: the
    Jacobian data is never copied for it."""
    bp, th, x0 = blocked_hard_family(n=32, d=64, device="cpu")
    J1 = th["J"].unsqueeze(0)
    assert J1.data_ptr() == th["J"].data_ptr()
    fns = bp.instance_fns({"J": J1, "y": th["y"].unsqueeze(0)})
    X = x0[None]
    assert fns.jac_res(X).shape == (1, 64, 32) and fns.residuals(X).shape == (1, 64)


def _oracle(bp, th, x, tol):
    xn = x.double().numpy()
    J0 = th["J"].double().numpy()
    r = J0 @ (xn + ALPHA * xn**3) - th["y"].double().numpy()
    J = J0 * (1.0 + 3.0 * ALPHA * xn * xn)[None, :]
    host = lambda t: t.double().numpy()
    return kkt_check_point(xn, r, J, None, None, host(bp.A), host(bp.b), host(bp.xl), host(bp.xu),
                           stat_tol=tol, feas_tol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_blocked_solve_matches_jax(dtype):
    td, jd = DTYPES[dtype]
    kw = dict(max_outer_iter=20, max_inner_iter=60)
    if dtype == "f64":
        kw["crit_tol"] = 1e-5
    bp, th, x0 = blocked_hard_family(n=256, d=512, dtype=td, device="cpu")
    x, y, info = solve_large_blocked_family(bp, th, x0, SolverOptions(**kw), make_mesh(1, 1, device="cpu"))
    jbp, jth, jx0 = j_family(n=256, d=512, dtype=jd)
    xj, yj, ij = j_solve(jbp, jth, jx0, JOptions(**kw), j_make_mesh(1, 1, devices=jax.devices()[:1]))
    assert x.dtype == td and x.shape == (256,) and y.shape == (0,)
    assert bool(info.converged) and bool(ij.converged)
    if dtype == "f64":
        assert (int(info.outer_iters), int(info.inner_iters)) == (int(ij.outer_iters), int(ij.inner_iters))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
        verdict = _oracle(bp, th, x, 1e-5)
    else:
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-4)
        verdict = _oracle(bp, th, x, 5e-4)
    assert verdict["ok"], verdict


ROUTES = [
    (dict(), 96, 512, "f32"), (dict(), 96, 512, "f64"), (dict(), 8, 16, "f32"),
    (dict(gram_hessian="on"), 8, 16, "f32"), (dict(gram_hessian="off"), 96, 512, "f32"),
    (dict(gn_factorization="cholqr2"), 96, 512, "f64"), (dict(gn_factorization="normal"), 96, 512, "f32"),
    (dict(gn_factorization="qr"), 96, 512, "f32"), (dict(gn_factorization="qr", gram_hessian="off"), 8, 16, "f64"),
]


@pytest.mark.parametrize("kw,n,dp,dtype", ROUTES)
@pytest.mark.parametrize("axis", [None, "block"])
def test_resolve_operator_route_matches_jax(kw, n, dp, dtype, axis):
    """Under an axis `auto` in float32 is CholeskyQR2 at any n, and an
    explicit "qr" raises ValueError whether or not the operator is built."""
    td, jd = DTYPES[dtype]
    t_opts, j_opts = SolverOptions(spmd_axis=axis, **kw), JOptions(spmd_axis=axis, **kw)
    if axis is not None and kw.get("gn_factorization") == "qr":
        for route, o, dt in ((resolve_operator_route, t_opts, td), (j_route, j_opts, jd)):
            with pytest.raises(ValueError, match="Householder"):
                route(o, n, dp, dt)
        return
    assert resolve_operator_route(t_opts, n, dp, td) == j_route(j_opts, n, dp, jd)


@pytest.mark.parametrize("build", ["gram_rows_xla", "gram_rows_ring", "r_rows", "r_replicated"])
def test_row_operators_on_one_rank_equal_the_whole_ones(build):
    """On a one-rank mesh each row-sharded operator holds all rows: its
    H·v and vᵀHv equal those of the replicated operator."""
    rng = np.random.default_rng(7)
    J, C = (torch.as_tensor(rng.standard_normal(s)) for s in ((2, 40, 12), (2, 3, 12)))
    H = tal.AlHessian(J, C, torch.tensor([2.0, 5.0], dtype=torch.float64))
    v = torch.as_tensor(rng.standard_normal((2, 12)))
    whole = tal.with_gram(H)
    with col.bind_mesh(make_mesh(1, 1, device="cpu")):
        Hs = {
            "gram_rows_xla": lambda: tal.with_gram_rows(H, "block", "xla"),
            "gram_rows_ring": lambda: tal.with_gram_rows(H, "block", "ring"),
            "r_rows": lambda: tal.with_r_factor_cholqr2(H, "block", "sharded"),
            "r_replicated": lambda: tal.with_r_factor_cholqr2(H, "block"),
        }[build]()
        assert (Hs.G_rows is not None) == build.startswith("gram") and (Hs.R_rows is not None) == (build == "r_rows")
        np.testing.assert_allclose(tal.hv(Hs, v, "block").numpy(), tal.hv(whole, v).numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tal.vhv(Hs, v, "block").numpy(), tal.vhv(whole, v).numpy(), rtol=1e-10)
