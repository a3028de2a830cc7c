"""The port's materialized Gauss-Newton operators (benlsip_tpu_torch.ops.qr
CholeskyQR2, ops.al Gram / QR / CholeskyQR2 builders, and the operator
routing of solver.subproblem) against the JAX package on CPU.

Inputs come from seeded numpy generators and go through both packages
(the JAX single-instance functions lifted with jax.vmap).  Tolerances:
- CholeskyQR2 R factors (unique: positive diagonal) — float64 1e-10,
  float32 1e-5 (LAPACK Cholesky and triangular solves on both sides; only
  summation order differs);
- the κ = 1e4 float32 rescue — RᵀR relative error ≤ 1e-5, the JAX suite's
  bar (`tests/test_cholqr2.py`);
- hv / vhv through every materialized operator against the dense
  JᵀJ + μCᵀC in float64 — 1e-12 relative.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.ops import al as jal
from benlsip_tpu.ops import qr as jqr
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu.solver.subproblem import resolve_operator_route as j_route
from benlsip_tpu_torch.ops import al as tal
from benlsip_tpu_torch.ops import qr as tqr
from benlsip_tpu_torch.solver.api import NLSFunctions
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.subproblem import linear_gram_cache, resolve_operator_route

torch.set_num_threads(2)


def _conditioned(rng, d, n, kappa):
    U, _ = np.linalg.qr(rng.standard_normal((d, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (U * np.logspace(0, -np.log10(kappa), n)) @ V.T


def _jax_gram_only(S):
    """JAX's R from the formed Gram alone: R₁ = chol(G), then the implicit pass."""
    G = S.T @ S
    return jqr._implicit_refine_upper(G, jqr._rescued_chol_upper(G))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("name", ["cholqr2_r", "cholqr2i_r", "implicit_refine_upper"])
def test_cholqr2_matches_jax(name, dtype):
    # The port's one CholeskyQR2 (`cholqr2i_r`, with its Gram formed or
    # given) against each JAX variant: R with a positive diagonal is unique.
    npd, tol = (np.float64, 1e-10) if dtype == "f64" else (np.float32, 1e-5)
    S = (np.random.default_rng(3).standard_normal((4, 80, 12)) / np.sqrt(80)).astype(npd)
    St = torch.from_numpy(S)
    R_t = tqr.cholqr2i_r(St, St.mT @ St) if name == "implicit_refine_upper" else tqr.cholqr2i_r(St)
    j_fn = _jax_gram_only if name == "implicit_refine_upper" else getattr(jqr, name)
    R_j = jax.vmap(j_fn)(jnp.asarray(S))
    assert R_t.dtype == St.dtype and R_t.shape == (4, 12, 12)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=tol, atol=tol)
    assert (torch.diagonal(R_t, dim1=-2, dim2=-1) > 0).all()


def test_shift_rescue_never_raises():
    # An exactly rank-deficient Gram breaks the unshifted Cholesky (NaN,
    # no exception); the shift rescue still yields a finite factor in that
    # lane and leaves the healthy lane's factor untouched.
    rng = np.random.default_rng(8)
    S = rng.standard_normal((2, 30, 6))
    S[1, :, 5] = S[1, :, 4]
    G = torch.from_numpy(np.swapaxes(S, 1, 2) @ S)
    plain = tqr._chol_upper(G)
    assert torch.isnan(plain[1]).all() and torch.isfinite(plain[0]).all()
    R = tqr._rescued_chol_upper(G)
    assert torch.isfinite(R).all()
    torch.testing.assert_close(R[0], plain[0], rtol=0, atol=0)
    # The rescued lane's last pivot is ~sqrt(σ) ≈ 1e-6 and carries the
    # rounding of a rank-deficient elimination: hold it to 1e-8 absolute.
    Rj = jax.vmap(jqr._rescued_chol_upper)(jnp.asarray(G.numpy()))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("route", ["cholqr2i_r", "with_r_factor_cholqr2"])
def test_rescue_ill_conditioned_f32_per_lane(route, monkeypatch):
    # Lane 0 has κ(S) = 1e4 in float32, where the implicit refinement
    # breaks down; lane 1 is well conditioned.  The explicit pass must
    # rescue lane 0 to RᵀR relative error ≤ 1e-5 and run on lane 0 only
    # (the JAX lax.cond under vmap is a per-instance select).
    rng = np.random.default_rng(12)
    J = np.stack([_conditioned(rng, 384, 96, 1e4), rng.standard_normal((384, 96)) / np.sqrt(384)])
    C = rng.standard_normal((2, 2, 96))
    seen = []
    orig = tqr._explicit_r2
    monkeypatch.setattr(tqr, "_explicit_r2", lambda S, R1: seen.append(S.shape[0]) or orig(S, R1))
    J32, C32 = torch.from_numpy(J).float(), torch.from_numpy(C).float()
    mu = 1e-3
    if route == "cholqr2i_r":
        R = tqr.cholqr2i_r(J32).double().numpy()
        G = np.swapaxes(J, 1, 2) @ J
    else:
        H = tal.with_r_factor_cholqr2(tal.AlHessian(J32, C32, torch.full((2,), mu)))
        assert H.G is None and H.R.dtype == torch.float32
        R = H.R.double().numpy()
        G = np.swapaxes(J, 1, 2) @ J + mu * np.swapaxes(C, 1, 2) @ C
    assert seen == [1]
    for i in range(2):
        err = np.linalg.norm(R[i].T @ R[i] - G[i]) / np.linalg.norm(G[i])
        assert err < 1e-5, (i, err)


def _operator_inputs(seed=4, B=3, d=40, n=9, p=3):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((B, d, n))
    C = rng.standard_normal((B, p, n))
    mu = rng.uniform(0.5, 3.0, B)
    v = rng.standard_normal((B, n))
    dense = np.swapaxes(J, 1, 2) @ J + mu[:, None, None] * (np.swapaxes(C, 1, 2) @ C)
    return J, C, mu, v, dense


BUILDERS = {
    "gram": lambda H: tal.with_gram(H),
    "gram_cached": lambda H: tal.with_gram(H, Gj=tal.gram_j(H.J)),
    "qr": tal.with_r_factor,
    "cholqr2": lambda H: tal.with_r_factor_cholqr2(H),
    "cholqr2_cached": lambda H: tal.with_r_factor_cholqr2(H, Gj=tal.gram_j(H.J)),
}


@pytest.mark.parametrize("p", [3, 0])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_operator_matches_dense(builder, p):
    J, C, mu, v, dense = _operator_inputs(p=p)
    H = BUILDERS[builder](tal.AlHessian(*map(torch.from_numpy, (J, C, mu))))
    assert (H.G is None) != (H.R is None)
    want_hv = np.einsum("bij,bj->bi", dense, v)
    want_vhv = np.einsum("bi,bi->b", v, want_hv)
    vt = torch.from_numpy(v)
    np.testing.assert_allclose(tal.hv(H, vt).numpy(), want_hv, rtol=1e-12, atol=1e-12 * np.abs(want_hv).max())
    np.testing.assert_allclose(tal.vhv(H, vt).numpy(), want_vhv, rtol=1e-12)


@pytest.mark.parametrize("builder", ["gram", "qr", "cholqr2"])
def test_operator_matches_jax(builder):
    # The materialized operator itself against the JAX builder's, float64.
    J, C, mu, v, _ = _operator_inputs(seed=6)
    H = BUILDERS[builder](tal.AlHessian(*map(torch.from_numpy, (J, C, mu))))
    j_build = {"gram": jal.with_gram, "qr": jal.with_r_factor, "cholqr2": jal.with_r_factor_cholqr2}[builder]
    Hj = jax.vmap(lambda J, C, mu: j_build(jal.AlHessian(J, C, mu)))(*map(jnp.asarray, (J, C, mu)))
    got, want = (H.G, Hj.G) if builder == "gram" else (H.R, Hj.R)
    if builder == "qr":   # Householder R is unique up to row signs
        got, want = got.mT @ got, np.swapaxes(np.asarray(want), 1, 2) @ np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-11, atol=1e-11)


def test_small_n_r_factor_goes_through_qr_kernel_gate(monkeypatch):
    # with_r_factor at small n in float32 reaches the MGS kernel's gate at
    # (B, d+p, n), as the JAX package's qr_r reaches its Pallas kernel.
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    shapes = []
    orig = kern.batched_thin_qr_plain
    monkeypatch.setattr(kern, "batched_thin_qr_plain", lambda S: shapes.append(tuple(S.shape)) or orig(S))
    J, C, mu, v, dense = _operator_inputs(B=5, d=32, n=3, p=1)
    H = tal.with_r_factor(tal.AlHessian(*(torch.from_numpy(a).float() for a in (J, C, mu))))
    assert shapes == [(5, 33, 3)]
    np.testing.assert_allclose(tal.hv(H, torch.from_numpy(v).float()).numpy(),
                               np.einsum("bij,bj->bi", dense, v), rtol=1e-4, atol=1e-4)


ROUTE_CASES = [
    (gh, fact, n, dp, dt)
    for gh in ("auto", "on", "off")
    for fact in ("auto", "normal", "qr", "cholqr2")
    for n, dp in ((3, 32), (64, 256), (192, 1024), (96, 150))
    for dt in ("float32", "float64")
]


@pytest.mark.parametrize("gh,fact", sorted({(c[0], c[1]) for c in ROUTE_CASES}))
def test_route_matches_jax(gh, fact):
    for _, _, n, dp, dt in [c for c in ROUTE_CASES if c[:2] == (gh, fact)]:
        got = resolve_operator_route(
            SolverOptions(gram_hessian=gh, gn_factorization=fact), n, dp, getattr(torch, dt))
        want = j_route(JOptions(gram_hessian=gh, gn_factorization=fact), n, dp, np.dtype(dt))
        assert got == want, (gh, fact, n, dp, dt, got, want)


@pytest.mark.parametrize("fact,cached", [("normal", True), ("cholqr2", True), ("qr", False), ("auto", True)])
def test_linear_gram_cache(fact, cached):
    # Computed once per solve for the operator routes that reuse JᵀJ; empty
    # for Householder QR, the matrix-free route and with the option off.
    rng = np.random.default_rng(2)
    B, d, n = 2, 160, 64
    J = torch.from_numpy(rng.standard_normal((d, n)))
    fns = NLSFunctions(
        residuals=lambda X: X @ J.T,
        nlconstraints=lambda X: X.new_zeros((X.shape[0], 0)),
        jac_res=lambda X: J.expand(X.shape[0], d, n),
        jac_nlcons=lambda X: X.new_zeros((X.shape[0], 0, n)),
    )
    x0 = torch.zeros((B, n), dtype=torch.float64)
    opts = SolverOptions(gn_factorization=fact, linear_residuals=True)
    cache = linear_gram_cache(fns, x0, opts)
    assert set(cache) == ({"Gj"} if cached else set())
    if cached:
        torch.testing.assert_close(cache["Gj"], (J.T @ J).expand(B, n, n), rtol=1e-13, atol=1e-13)
    assert linear_gram_cache(fns, x0, dataclasses.replace(opts, linear_residuals=False)) == {}
    assert linear_gram_cache(fns, x0[:, :3], opts) == {}   # n < 64: matrix-free
