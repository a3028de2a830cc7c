"""The config-3 dense path of the port (dense_quadratic_family: materialized
Gauss-Newton operators in the bulk, the LU / split / fused certification)
against the JAX package on CPU, at a small size (B ≤ 8, n = 96, d = 384,
m = 3; config 3 itself is B = 64, n = 192, d = 1024, m = 6).

Both packages get bit-identical data from the same numpy recipe.
Tolerances:
- bulk solves in float64 — the same status on every lane and X within
  1e-7 (the same algorithm; a lane at the f64 criticality floor may spend
  a different number of iterations there);
- SQP polish from one warm start — the same certification mask and X
  within 1e-9 (rtol 1e-7): the LU pivots of LAPACK may differ between the
  two stacks, so solutions are compared, not factors;
- the pipeline — every lane certified at pix ≤ 1.5e-8 on both sides and X
  within 1e-7, the bar the JAX device-vs-host certification uses.
"""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.batch import polish as jpolish
from benlsip_tpu.batch.refine import _cast_tree as j_cast
from benlsip_tpu.batch.refine import solve_mixed_precision as j_mixed
from benlsip_tpu.batch.vmap_solve import solve_batched_chunked as j_solve
from benlsip_tpu.problems import generators as jgen
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch import polish as tpolish
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
from benlsip_tpu_torch.problems import generators as tgen
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.subproblem import OPERATOR_BUILDS, reset_operator_builds

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=30, max_inner_iter=100)
SMALL = dict(n=96, d=384, m=3, seed=5)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_generator_bit_identical(dtype):
    kw = dict(B=6, n=70, d=150, m=4, seed=3)
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    bp_j, th_j, X0_j = jgen.dense_quadratic_family(dtype=jd, **kw)
    bp_t, th_t, X0_t = tgen.dense_quadratic_family(dtype=td, **kw)
    np.testing.assert_array_equal(th_t["y"].numpy(), np.asarray(th_j["y"]))
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    for f in ("A", "b", "xl", "xu"):
        np.testing.assert_array_equal(getattr(bp_t, f).numpy(), np.asarray(getattr(bp_j, f)))
    assert bp_t.poly_batched == bp_j.poly_batched is False
    # The shared J is cast to the caller's dtype inside the callables, once
    # per dtype, and the batched Jacobian is a stride-0 expand of it.
    fns = bp_t.instance_fns(th_t)
    J = fns.jac_res(X0_t.float())
    assert J.dtype == torch.float32 and J.shape == (kw["B"], kw["d"], kw["n"]) and J.stride(0) == 0
    assert fns.jac_res(X0_t.float() + 1).data_ptr() == J.data_ptr()
    i0 = {k: v[0] for k, v in th_j.items()}
    np.testing.assert_array_equal(J[0].numpy(), np.asarray(bp_j.jac_res(X0_j[0].astype(jnp.float32), i0)))
    # Residuals are products: equal up to the matmuls' summation order.
    np.testing.assert_allclose(fns.residuals(X0_t).numpy(), np.asarray(
        jnp.stack([bp_j.residuals(X0_j[i], {"y": th_j["y"][i]}) for i in range(kw["B"])])),
        rtol=0, atol=1e-13 if dtype == "f64" else 1e-6)


@pytest.mark.parametrize("lin", [False, True])
@pytest.mark.parametrize("fact", ["normal", "qr", "cholqr2"])
def test_solve_batched_matches_jax(fact, lin):
    # n = 96 and d = 384 ≥ 2n: both packages materialize the operator, and
    # n − m = 93 > 32 takes the projected Cauchy variant at its default.
    bp_j, th_j, X0_j = jgen.dense_quadratic_family(4, **SMALL)
    bp_t, th_t, X0_t = tgen.dense_quadratic_family(4, **SMALL)
    kw = dict(gn_factorization=fact, linear_residuals=lin, **OPTS)
    Xj, _, ij = j_solve(bp_j, th_j, X0_j, JOptions(**kw), chunk=4)
    reset_operator_builds()
    Xt, _, it = solve_batched_chunked(bp_t, th_t, X0_t, SolverOptions(**kw), chunk=4)
    # Every subproblem materialized the requested operator, and no other.
    assert set(OPERATOR_BUILDS) == {(fact, "float64")} and OPERATOR_BUILDS[(fact, "float64")] > 0
    np.testing.assert_array_equal(it.status.numpy(), np.asarray(ij.status))
    assert bool(it.converged.all())
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _warm_start(B: int):
    """The port's f32 bulk point on the small config-3 family, as numpy."""
    bp, th, X0 = tgen.dense_quadratic_family(B, **SMALL)
    bp32, th32 = _cast_problem(bp, torch.float32, "cpu"), _cast_tree(th, torch.float32)
    X32, _, _ = solve_batched_chunked(bp32, th32, X0.float(), SolverOptions(crit_tol=1e-2, **OPTS), chunk=B)
    return X32.numpy()


def _both(B: int):
    bp_j, th_j, _ = jgen.dense_quadratic_family(B, **SMALL)
    bp_t, th_t, _ = tgen.dense_quadratic_family(B, **SMALL)
    return bp_j, th_j, bp_t, th_t, _warm_start(B)


def _assert_polish_agrees(out_t, out_j):
    Xt, _, okt, pixt, _, _ = out_t
    Xj, _, okj, _, _, _ = out_j
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert bool(okt.all()) and float(pixt.max()) <= 1.5e-8
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("kkt", ["lu", "qr"])
def test_sqp_polish_matches_jax(kkt):
    bp_j, th_j, bp_t, th_t, X32 = _both(8)
    kw = dict(num_steps=5, kkt_factorization=kkt)
    out_j = jpolish.sqp_polish(bp_j, th_j, jnp.asarray(X32, jnp.float64), JOptions(**OPTS), **kw)
    out_t = tpolish.sqp_polish(bp_t, th_t, torch.from_numpy(X32).double(), SolverOptions(**OPTS), **kw)
    _assert_polish_agrees(out_t, out_j)


def test_split_polish_matches_jax():
    # f32 range-space QR factors where X32 lives, f64 chord steps on the CPU.
    bp_j, th_j, bp_t, th_t, X32 = _both(8)
    cast = lambda a: a.astype(jnp.float32)
    bp32_j = dataclasses.replace(bp_j, A=cast(bp_j.A), b=cast(bp_j.b), xl=cast(bp_j.xl), xu=cast(bp_j.xu))
    out_j = jpolish.sqp_polish_split(
        bp32_j, j_cast(th_j, jnp.float32), jnp.asarray(X32), bp_j, th_j, JOptions(**OPTS),
        num_steps=5, kkt_factorization="qr")
    out_t = tpolish.sqp_polish_split(
        _cast_problem(bp_t, torch.float32, "cpu"), _cast_tree(th_t, torch.float32), torch.from_numpy(X32),
        bp_t, th_t, SolverOptions(**OPTS), num_steps=5)
    assert out_t[0].dtype == torch.float64 and out_t[0].device.type == "cpu"
    _assert_polish_agrees(out_t, out_j)


def test_fused_polish_factors_through_the_panel_qr(monkeypatch):
    # n = 96 > 16: the f32 range-space factor RJ = qr_r([JZ; D]) at
    # (B, d + n, n) takes the panel QR's plain version on a CPU tensor (block
    # Gram–Schmidt), where the JAX package takes XLA's Householder.  The KKT
    # step uses RJ through RJᵀRJ-invariant combinations only, so X and the
    # certificate agree at the polish tolerance of this file.
    from benlsip_tpu_torch.kernels import batched_linalg as tk

    shapes = []
    plain = tk.blocked_qr_r_plain
    monkeypatch.setattr(tk, "blocked_qr_r_plain", lambda S: shapes.append((tuple(S.shape), S.dtype)) or plain(S))
    bp_j, th_j, bp_t, th_t, X32 = _both(8)
    cast = lambda a: a.astype(jnp.float32)
    bp32_j = dataclasses.replace(bp_j, A=cast(bp_j.A), b=cast(bp_j.b), xl=cast(bp_j.xl), xu=cast(bp_j.xu))
    out_j = jpolish.sqp_polish_fused(
        bp32_j, j_cast(th_j, jnp.float32), jnp.asarray(X32), bp_j, th_j, JOptions(**OPTS), num_steps=5)
    out_t = tpolish.sqp_polish_fused(
        _cast_problem(bp_t, torch.float32, "cpu"), _cast_tree(th_t, torch.float32), torch.from_numpy(X32),
        bp_t, th_t, SolverOptions(**OPTS), num_steps=5)
    n, d = SMALL["n"], SMALL["d"]
    assert shapes and set(shapes) == {((8, d + n, n), torch.float32)}, shapes
    _assert_polish_agrees(out_t, out_j)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(B: int):
    bp_j, th_j, X0_j = jgen.dense_quadratic_family(B, **SMALL)
    Xj, _, ij = j_mixed(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=B)
    assert bool(np.asarray(ij.converged).all()) and float(jnp.max(ij.pix)) <= 1.5e-8
    return np.asarray(Xj)


@pytest.mark.parametrize("certify", ["device", "host"])
def test_mixed_precision_matches_jax(certify):
    B = 8
    bp, th, X0 = tgen.dense_quadratic_family(B, **SMALL)
    X, Y, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=B, certify=certify)
    assert bool(info.converged.all()) and float(info.pix.max()) <= 1.5e-8
    assert X.dtype == torch.float64 and X.shape == (B, 96) and Y.shape == (B, 0)
    np.testing.assert_allclose(X.numpy(), _jax_pipeline(B), rtol=0, atol=1e-7)


ROUTES = [
    # (device, family, with the f32 working set) -> polisher
    (None, "dense", True, "sqp_polish_fused"),
    (None, "dense", False, "sqp_polish"),
    ("cpu", "dense", True, "sqp_polish_split"),
    ("cpu", "dense", False, "sqp_polish"),
    ("cpu", "exp_fit", True, "sqp_polish"),
]


@pytest.mark.parametrize("device,family,with32,want", ROUTES)
def test_polish_then_refine_routes(device, family, with32, want, monkeypatch):
    # The route follows from the inputs, as the JAX defaults route: fused on
    # X32's device; for the host certification the split polish at n ≥ 64
    # with the f32 working set, else the all-f64 polish on the CPU.
    calls = []
    for name in ("sqp_polish_fused", "sqp_polish_split", "sqp_polish"):
        orig = getattr(tpolish, name)
        monkeypatch.setattr(tpolish, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    if family == "dense":
        bp, th, _ = tgen.dense_quadratic_family(8, **SMALL)
        X32 = torch.from_numpy(_warm_start(8))
    else:
        bp, th, X0 = tgen.exp_fit_family(8, d=16, seed=3)
        X32, _, _ = solve_batched_chunked(
            _cast_problem(bp, torch.float32, "cpu"), _cast_tree(th, torch.float32), X0.float(),
            SolverOptions(crit_tol=1e-2, max_outer_iter=40, max_inner_iter=8), chunk=8)
    kw = dict(bp32=_cast_problem(bp, torch.float32, "cpu"), theta32=_cast_tree(th, torch.float32)) if with32 else {}
    X, Y, info = tpolish.polish_then_refine(
        bp, th, X32, SolverOptions(**OPTS), num_steps=5, device=device, **kw)
    assert calls[0] == want and set(calls[1:]) <= {"sqp_polish"}, calls
    assert bool(info.converged.all()) and float(info.pix.max()) <= 1.5e-8


def test_polish_argument_checks():
    bp, th, X0 = tgen.exp_fit_family(2, d=8, seed=0)
    with pytest.raises(ValueError):
        tpolish.polish_then_refine(bp, th, X0.float(), device="cuda:0")
    with pytest.raises(ValueError):
        tpolish.sqp_polish(bp, th, X0, kkt_factorization="cholesky")
    with pytest.raises(ValueError):
        solve_mixed_precision(bp, th, X0, certify="gpu")
