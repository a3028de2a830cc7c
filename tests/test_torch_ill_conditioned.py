"""`problems/generators.ill_conditioned_family` and the range-space QR
polish on it, against the JAX package (port of
`tests/test_qr_path.py::test_split_polish_qr_beats_lu_ill_conditioned`).

At κ(J) = 1e4 the assembled-KKT LU holds JᵀJ, so its float32 factor has
O(κ²·eps) error and its iterative refinement does not certify; the
range-space QR factor RJ = qr_r([JZ; D]) is O(κ·eps) and certifies the
same instances as the all-f64 polish.  On a float32 CPU tensor with
16 < N ≤ 256 and a batch of 4 or more, `qr_r` is the panel QR's plain
version: at n = 96 its panels of 32 columns are full, at n = 100 the last
holds 4 columns, where one block projection pass left R up to 1e2·κ·eps
off (tests/test_torch_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch.polish import sqp_polish as j_polish, sqp_polish_split as j_split
from benlsip_tpu.batch.vmap_solve import solve_batched as j_solve_batched
from benlsip_tpu.problems.generators import ill_conditioned_family as j_family
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch import SolverOptions
from benlsip_tpu_torch.batch.polish import sqp_polish, sqp_polish_split
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
from benlsip_tpu_torch.batch.vmap_solve import solve_batched
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.problems.generators import ill_conditioned_family

torch.set_num_threads(2)
B = 8
BULK = dict(max_outer_iter=20, max_inner_iter=80, crit_tol=1e-2)
OPTS = dict(max_outer_iter=20, max_inner_iter=80)


@pytest.mark.parametrize("kw", [{}, {"n": 100, "d": 300, "m": 2, "kappa": 1e5, "seed": 4}])
def test_family_data_bit_identical_to_jax(kw):
    bp_j, th_j, X0_j = j_family(3, **kw)
    bp_t, th_t, X0_t = ill_conditioned_family(3, **kw, device="cpu")
    np.testing.assert_array_equal(th_t["y"].numpy(), np.asarray(th_j["y"]))
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    for f in ("A", "b", "xl", "xu"):
        np.testing.assert_array_equal(getattr(bp_t, f).numpy(), np.asarray(getattr(bp_j, f)))
    x = X0_t[0]
    np.testing.assert_array_equal(bp_t.jac_res(x, None).numpy(), np.asarray(bp_j.jac_res(X0_j[0], None)))
    # r = J x − y: the same data, a matrix-vector product summed in another order.
    np.testing.assert_allclose(bp_t.residuals(x, {"y": th_t["y"][0]}).numpy(),
                               np.asarray(bp_j.residuals(X0_j[0], {"y": th_j["y"][0]})), rtol=0, atol=1e-12)
    assert X0_t.dtype == torch.float64 and ill_conditioned_family(2, dtype=torch.float32, device="cpu")[2].dtype == torch.float32


def _port_sets(bp, th, bp32, th32, X32):
    """Certified masks of the split polish with the LU and the QR factor,
    and of the all-f64 polish, from the f32 points X32 (8 Newton steps)."""
    opts = SolverOptions(**OPTS)
    lu = sqp_polish_split(bp32, th32, X32, bp, th, opts, num_steps=8, kkt_factorization="lu")[2].numpy()
    qr = sqp_polish_split(bp32, th32, X32, bp, th, opts, num_steps=8, kkt_factorization="qr")[2].numpy()
    f64 = sqp_polish(bp, th, X32.double(), opts, num_steps=8)[2].numpy()
    return lu, qr, f64


# At n = 100 the f64 polish itself certifies 3 of the 8 instances of seed 9
# from the f32 bulk, in both packages (at n = 96: 4).
@pytest.mark.parametrize("n,least", [(96, 4), (100, 3)])
def test_split_polish_qr_beats_lu_ill_conditioned(n, least, monkeypatch):
    shapes = []
    plain = tk.blocked_qr_r_plain
    monkeypatch.setattr(tk, "blocked_qr_r_plain", lambda S: shapes.append(tuple(S.shape)) or plain(S))

    # The JAX package, as its own test runs it.
    bp_j, th_j, X0_j = j_family(B, n=n, kappa=1e4, seed=9)
    c = lambda a: a.astype(jnp.float32)
    bp32_j = dataclasses.replace(bp_j, A=c(bp_j.A), b=c(bp_j.b), xl=c(bp_j.xl), xu=c(bp_j.xu))
    th32_j = jax.tree.map(c, th_j)
    X32_j = j_solve_batched(bp32_j, th32_j, c(X0_j), JOptions(**BULK))[0]
    j_lu, j_qr, j_f64 = (np.asarray(out[2]) for out in (
        j_split(bp32_j, th32_j, X32_j, bp_j, th_j, JOptions(**OPTS), num_steps=8, kkt_factorization="lu"),
        j_split(bp32_j, th32_j, X32_j, bp_j, th_j, JOptions(**OPTS), num_steps=8, kkt_factorization="qr"),
        j_polish(bp_j, th_j, X32_j.astype(jnp.float64), JOptions(**OPTS), num_steps=8),
    ))
    assert j_lu.sum() < j_f64.sum() and (j_qr == j_f64).all() and j_qr.sum() >= least

    # The port's own pipeline: its f32 bulk, then its polishes.
    bp, th, X0 = ill_conditioned_family(B, n=n, kappa=1e4, seed=9, device="cpu")
    bp32, th32 = _cast_problem(bp, torch.float32, "cpu"), _cast_tree(th, torch.float32)
    X32 = solve_batched(bp32, th32, X0.float(), SolverOptions(**BULK))[0]
    lu, qr, f64 = _port_sets(bp, th, bp32, th32, X32)
    assert lu.sum() < f64.sum()
    assert (qr == f64).all() and qr.sum() >= least
    # The QR route's factor is the panel QR at (B, d + n, n).
    assert set(shapes) == {(B, 384 + n, n)}

    # Both packages' polishes from the same f32 points: the same QR and f64 sets.
    _, qr_on_j, f64_on_j = _port_sets(bp, th, bp32, th32, torch.from_numpy(np.array(X32_j)))
    np.testing.assert_array_equal(qr_on_j, j_qr)
    np.testing.assert_array_equal(f64_on_j, j_f64)
    np.testing.assert_array_equal(qr, j_qr)


def test_pipeline_matches_jax_ill_conditioned():
    # solve_mixed_precision with the host certification (the JAX default's
    # route: the f32 bulk, the all-f64 polish on the CPU at n < 64, the
    # re-polish round and the fallback refine) against the JAX default.
    # The float32 bulks part at this conditioning (up to 0.15 in X), yet
    # the polish certifies the same lanes, and to the same points; every
    # lane ends certified with the same status.  The lanes the fallback
    # refine finishes are not held to JAX's X: its trajectories part at a
    # Cauchy direction of rounding size (ROADMAP §3).
    from benlsip_tpu.batch.refine import solve_mixed_precision as j_mixed
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision

    kw = dict(n=12, d=48, kappa=1e4, seed=9)
    opts = dict(max_outer_iter=30, max_inner_iter=100)
    bp_j, th_j, X0_j = j_family(B, **kw)
    Xj, _, ij = j_mixed(bp_j, th_j, X0_j, JOptions(**opts), chunk=B)
    bp, th, X0 = ill_conditioned_family(B, **kw, device="cpu")
    Xt, _, it = solve_mixed_precision(bp, th, X0, SolverOptions(**opts), chunk=B, certify="host")
    assert Xt.device.type == "cpu" and bool(it.converged.all())
    np.testing.assert_array_equal(it.converged.numpy(), np.asarray(ij.converged))
    np.testing.assert_array_equal(it.status.numpy(), np.asarray(ij.status))
    polished = (it.outer_iters == 0).numpy()
    np.testing.assert_array_equal(polished, np.asarray(ij.outer_iters) == 0)
    assert 0 < polished.sum() < B
    np.testing.assert_allclose(Xt.numpy()[polished], np.asarray(Xj)[polished], rtol=1e-7, atol=1e-9)
