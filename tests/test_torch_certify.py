"""The port's f64 certification (benlsip_tpu_torch.batch.polish: f32 QR
factors through the MGS QR kernel gate, f64 chord steps, exact-projection
certificate, re-polish rounds, full-refine fallback) and the whole slice
(batch.refine.solve_mixed_precision) against the JAX package on CPU.

Inputs: the config-2 family from the same numpy recipe, and the same f32
bulk point X32 handed to both sides as numpy.  Tolerances:
- polish: rtol 1e-7, atol 1e-9 on lanes both certify (the two QR routes
  differ in sign conventions — MGS here, Householder in XLA on CPU — but
  the KKT step is invariant to them, so only f32 factor rounding differs,
  and the f64 chord steps iterate it away);
- slice: both certify every lane at pix ≤ 1.5e-8 and X agrees within
  atol 1e-7, the bar the JAX device-vs-host certification uses.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.batch.polish import sqp_polish_fused as j_polish
from benlsip_tpu.batch.refine import _cast_tree as j_cast
from benlsip_tpu.batch.refine import solve_mixed_precision as j_mixed
from benlsip_tpu.batch.vmap_solve import solve_batched_chunked as j_solve
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch.polish import polish_then_refine, sqp_polish, sqp_polish_fused, sqp_polish_split
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)


def _f32(bp, theta):
    return _cast_problem(bp, torch.float32, "cpu"), _cast_tree(theta, torch.float32)


def test_fused_polish_matches_jax():
    B = 32
    bp_j, th_j, X0_j = j_exp_fit(B, d=32, seed=13)
    th32_j = j_cast(th_j, jnp.float32)
    bp32_j = dataclasses.replace(
        bp_j, A=bp_j.A.astype(jnp.float32), b=bp_j.b.astype(jnp.float32),
        xl=bp_j.xl.astype(jnp.float32), xu=bp_j.xu.astype(jnp.float32))
    bulk = JOptions(crit_tol=1e-2, max_outer_iter=40, max_inner_iter=8)
    X32_j, _, _ = j_solve(bp32_j, th32_j, X0_j.astype(jnp.float32), bulk, chunk=B)
    opts_j = JOptions(**OPTS)
    Xj, Yj, okj, pixj, feasj, objj = j_polish(bp32_j, th32_j, X32_j, bp_j, th_j, opts_j, num_steps=5)

    bp, th, _ = exp_fit_family(B, d=32, seed=13)
    bp32, th32 = _f32(bp, th)
    X32 = torch.from_numpy(np.array(X32_j))
    Xt, Yt, okt, pixt, feast, objt = sqp_polish_fused(bp32, th32, X32, bp, th, SolverOptions(**OPTS), num_steps=5)
    okt_np, okj_np = okt.numpy(), np.asarray(okj)
    assert okt_np.all() and okj_np.all(), (okt_np.sum(), okj_np.sum())
    both = okt_np & okj_np
    np.testing.assert_allclose(Xt.numpy()[both], np.asarray(Xj)[both], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(objt.numpy()[both], np.asarray(objj)[both], rtol=1e-7, atol=1e-12)
    assert Yt.shape == (B, 0) and float(pixt.max()) <= 1.5e-8 and float(feast.max()) <= 1.5e-8


def test_straggler_buckets_and_fallback():
    # A cold start far from the solution with a thin step budget leaves a
    # straggler population.  Bucketed re-polish (bucket 4) must certify at
    # least as many lanes as a full-width bucket and agree on them; the
    # fallback refine then certifies every lane.
    B = 32
    bp, th, X0 = exp_fit_family(B, d=32, seed=13)
    bp32, th32 = _f32(bp, th)
    opts = SolverOptions(**OPTS)
    X32 = X0.to(torch.float32)
    kw = dict(num_steps=3, refactor_steps=2, rounds=4)
    Xs, _, oks, *_ = sqp_polish_fused(bp32, th32, X32, bp, th, opts, straggler_bucket=4, **kw)
    Xf, _, okf, *_ = sqp_polish_fused(bp32, th32, X32, bp, th, opts, straggler_bucket=B, **kw)
    assert int(oks.sum()) >= int(okf.sum()) > 0
    assert int(okf.sum()) < B   # there were stragglers to serve
    both = (oks & okf).numpy()
    np.testing.assert_allclose(Xs.numpy()[both], Xf.numpy()[both], rtol=1e-7, atol=1e-9)

    X, Y, info = polish_then_refine(bp, th, X32, opts, num_steps=3, bp32=bp32, theta32=th32)
    assert bool(info.converged.all()), int(info.converged.sum())
    assert float(info.pix.max()) <= 1.5e-8 and X.dtype == torch.float64


def test_fallback_stall_restart_rescue():
    # The JAX suite's config-5 uncertified-tail fixture (seed 7, instance
    # 9996: a near-degenerate slow decay) must certify through the port's
    # pipeline too.
    bp, th, X0 = exp_fit_family(16384, d=32, seed=7)
    i = 9996
    bp_i = dataclasses.replace(bp, b=bp.b[i : i + 1])
    th_i = {k: v[i : i + 1] for k, v in th.items()}
    X, Y, info = solve_mixed_precision(bp_i, th_i, X0[i : i + 1], SolverOptions(**OPTS), chunk=1)
    assert bool(info.converged[0]), (float(info.pix[0]), int(info.status[0]))
    assert float(info.pix[0]) <= 1.5e-8


def test_refine_route_matches_polish_route():
    # polish=False refines every lane with the full f64 solver from the f32
    # bulk point; it must certify the same solutions as the polish route
    # (atol 1e-7: two different f64 routes to the same KKT point).
    B = 8
    bp, th, X0 = exp_fit_family(B, d=32, seed=21)
    opts = SolverOptions(**OPTS)
    Xr, _, ir = solve_mixed_precision(bp, th, X0, opts, chunk=B, polish=False)
    Xp, _, ip = solve_mixed_precision(bp, th, X0, opts, chunk=B)
    assert bool(ir.converged.all()) and bool(ip.converged.all())
    assert int(ir.outer_iters.max()) > 0 and int(ip.outer_iters.max()) == 0
    np.testing.assert_allclose(Xr.numpy(), Xp.numpy(), rtol=0, atol=1e-7)


def test_slice_matches_jax():
    B = 32
    bp_j, th_j, X0_j = j_exp_fit(B, d=32, seed=13)
    Xj, _, ij = j_mixed(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=B)
    bp, th, X0 = exp_fit_family(B, d=32, seed=13)
    Xt, Yt, it = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=B)
    assert int(ij.converged.sum()) == B and bool(it.converged.all())
    assert float(jnp.max(ij.pix)) <= 1.5e-8 and float(it.pix.max()) <= 1.5e-8
    assert Xt.dtype == torch.float64 and Xt.shape == (B, 3)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)
    # TF32 is switched off where the pipeline starts.
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("polisher", ["fused", "split", "all_f64"])
def test_polish_always_runs_a_chord_step(polisher):
    # refactor_steps ≥ num_steps is clamped to num_steps - 1: the
    # certificate is taken after at least one f64 chord step, never at the
    # f32 factor point, so refactor_steps = num_steps = 3 gives exactly the
    # refactor_steps = 2 result.  A budget of one step has no room for both.
    B = 8
    bp, th, X0 = exp_fit_family(B, d=16, seed=3)
    bp32, th32 = _f32(bp, th)
    X32, _, _ = solve_batched_chunked(
        bp32, th32, X0.float(), SolverOptions(crit_tol=1e-2, max_outer_iter=40, max_inner_iter=8), chunk=B)
    opts = SolverOptions(**OPTS)
    run = {
        "fused": lambda **k: sqp_polish_fused(bp32, th32, X32, bp, th, opts, **k),
        "split": lambda **k: sqp_polish_split(bp32, th32, X32, bp, th, opts, **k),
        "all_f64": lambda **k: sqp_polish(bp, th, X32.double(), opts, **k),
    }[polisher]
    X3, _, ok3, *_ = run(num_steps=3, refactor_steps=3)
    X2, _, ok2, *_ = run(num_steps=3, refactor_steps=2)
    torch.testing.assert_close(X3, X2, rtol=0, atol=0)
    assert torch.equal(ok3, ok2) and bool(ok2.any())
    with pytest.raises(ValueError):
        run(num_steps=1, refactor_steps=1)
