"""The plain PyTorch versions of the CUDA kernels (benlsip_tpu_torch/kernels)
against the Pallas kernels they replace, run in interpret mode.

Same cases as tests/test_kernels.py (B = 200/130/140, not lane-aligned),
plus the empty batches, the NaN-on-non-SPD contract and the dispatch gate.
The plain versions of the two fused kernels (`masked_aat_cholesky`,
`project_tangent`) are held against the JAX package's call sites,
`ops/cholesky.factor_masked_aat` and `ops/project.project_tangent` under
jax.vmap, and their NaN patterns against the Pallas kernels.  The plain
version of the panel QR kernel (`blocked_qr_r`, 16 < N) is held against the
JAX package's `ops/qr.qr_r` under jax.vmap, which takes XLA's Householder
at those widths: RᵀR against SᵀS, and R against the sign-normalised JAX R
at a tolerance that grows with κ(S).
Inputs are float32 from a numpy generator of each test's own, seeded from
its node id (the `rng` fixture), and go through both.
Tolerance 1e-5 (relative, atol 1e-5): both sides run the same algorithm in
the same order, so they differ only by float32 rounding of the reductions.
The kernels themselves compile and run only on the GPU; chip_smoke.py holds
them against these plain versions there.
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.kernels import batched_linalg as jk
from benlsip_tpu.ops import cholesky as jchol
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import project as jpr
from benlsip_tpu.ops import qr as jqr
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import cholesky as tchol
from benlsip_tpu_torch.ops import constraints as tc
from benlsip_tpu_torch.ops import project as tpr
from benlsip_tpu_torch.ops import qr as tqr

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def rng(request):
    """This test's own generator, seeded from its node id: its inputs do not
    depend on the tests that ran before it in the same worker."""
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def spd_batch(rng, B, M, dtype=np.float32):
    A = rng.standard_normal((B, M, M)).astype(dtype)
    return A @ np.transpose(A, (0, 2, 1)) + M * np.eye(M, dtype=dtype)


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_cholesky_plain_matches_pallas(M, rng):
    K = spd_batch(rng, 200, M)
    L_pl = np.asarray(jk.batched_cholesky(jnp.asarray(K), interpret=True))
    L_t = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L_t, L_pl, **TOL)
    assert np.all(np.triu(L_t, 1) == 0)


@pytest.mark.parametrize("M", [1, 3, 6])
def test_cho_solve_plain_matches_pallas(M, rng):
    K = spd_batch(rng, 130, M)
    L = np.linalg.cholesky(K).astype(np.float32)
    b = rng.standard_normal((130, M)).astype(np.float32)
    x_pl = np.asarray(jk.batched_cho_solve(jnp.asarray(L), jnp.asarray(b), interpret=True))
    x_t = tk.batched_cho_solve(torch.from_numpy(L), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x_t, x_pl, rtol=1e-5, atol=1e-5 * np.abs(x_pl).max())


def test_largest_factor_matches_lapack(rng):
    # M = 16, the kernels' upper bound, against LAPACK (the Pallas
    # interpreter takes ~20 s at this size).  Tolerance 2e-5: float32
    # rounding of an O(M) accumulation, different order from LAPACK's.
    K = spd_batch(rng, 64, 16)
    L = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), rtol=2e-5, atol=2e-5)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    x = tk.batched_cho_solve(torch.from_numpy(L), torch.from_numpy(b)).numpy()
    x_ref = np.linalg.solve(K.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,N", [(8, 3), (32, 3), (16, 8), (35, 3), (3, 1)])
def test_thin_qr_plain_matches_pallas(D, N, rng):
    A = rng.standard_normal((140, D, N)).astype(np.float32)
    Q_pl, R_pl = jk.batched_thin_qr(jnp.asarray(A), interpret=True)
    Q_t, R_t = tk.batched_thin_qr(torch.from_numpy(A))
    np.testing.assert_allclose(Q_t.numpy(), np.asarray(Q_pl), **TOL)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_pl), rtol=1e-5, atol=1e-5 * np.sqrt(D))
    R = R_t.numpy()
    assert np.all(np.tril(R, -1) == 0) and np.all(np.diagonal(R, axis1=1, axis2=2) > 0)


def test_non_spd_pivot_gives_nan_like_pallas(rng):
    # No clamping: a negative pivot is NaN in both; the earlier columns
    # stay finite.
    K = spd_batch(rng, 4, 3)
    K[1, 2, 2] = -50.0
    L_pl = np.asarray(jk.batched_cholesky(jnp.asarray(K), interpret=True))
    L_t = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    assert np.isnan(L_t[1, 2, 2]) and np.isnan(L_pl[1, 2, 2])
    np.testing.assert_array_equal(np.isnan(L_t), np.isnan(L_pl))
    assert np.isfinite(L_t[[0, 2, 3]]).all()


def test_zero_column_qr_floors_at_tiny(rng):
    A = rng.standard_normal((5, 6, 2)).astype(np.float32)
    A[2, :, 1] = 0.0
    Q_pl, R_pl = jk.batched_thin_qr(jnp.asarray(A), interpret=True)
    Q_t, R_t = tk.batched_thin_qr(torch.from_numpy(A))
    assert np.isfinite(Q_t.numpy()).all()
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_pl), **TOL)
    np.testing.assert_allclose(Q_t.numpy(), np.asarray(Q_pl), **TOL)


def test_empty_and_degenerate_batches():
    z = torch.zeros
    assert tk.batched_cholesky(z((0, 3, 3))).shape == (0, 3, 3)
    assert tk.batched_cho_solve(z((4, 0, 0)), z((4, 0))).shape == (4, 0)
    Q, R = tk.batched_thin_qr(z((0, 5, 2)))
    assert Q.shape == (0, 5, 2) and R.shape == (0, 2, 2)
    Q, R = tk.batched_thin_qr(z((3, 5, 0)))
    assert Q.shape == (3, 5, 0) and R.shape == (3, 0, 0)
    # The JAX wrappers return the same shapes.
    assert jk.batched_cholesky(jnp.zeros((0, 3, 3)), interpret=True).shape == (0, 3, 3)


def test_dispatch_gate(rng):
    # Eligible float32 and bf16 CPU tensors run the plain version (no
    # launch), f64 and M > 16 go to torch.linalg, and a tensor on a device
    # that is neither cpu nor cuda is refused by the wrappers.
    tk.reset_launches()
    K32 = torch.from_numpy(spd_batch(rng, 7, 3))
    np.testing.assert_allclose(
        tchol.cholesky(K32).numpy(), tk.batched_cholesky_plain(K32).numpy(), rtol=0, atol=0
    )
    K64 = K32.double()
    np.testing.assert_allclose(
        tchol.cholesky(K64).numpy(), np.linalg.cholesky(K64.numpy()), rtol=1e-12
    )
    K20 = torch.from_numpy(spd_batch(rng, 2, 20))
    np.testing.assert_allclose(
        tchol.cholesky(K20).numpy(), np.linalg.cholesky(K20.numpy()), rtol=1e-4, atol=1e-5
    )
    # Non-PD through the library route: LAPACK's NaN signal, not an exception.
    bad = K64.clone()
    bad[0] = -torch.eye(3, dtype=torch.float64)
    Lb = tchol.cholesky(bad)
    assert torch.isnan(Lb[0]).all() and torch.isfinite(Lb[1:]).all()
    Kb = K32.to(torch.bfloat16)
    Lb = tchol.cholesky(Kb)
    assert Lb.dtype == torch.bfloat16
    np.testing.assert_array_equal(Lb.float().numpy(), tk.batched_cholesky_plain(Kb.float()).to(torch.bfloat16).float().numpy())
    Rb = tqr.qr_r(torch.zeros((2, 4, 2), dtype=torch.bfloat16))
    assert Rb.dtype == torch.bfloat16 and Rb.shape == (2, 2, 2) and torch.isfinite(Rb.float()).all()
    with pytest.raises(ValueError):
        tk.batched_cholesky(torch.zeros((2, 3, 3), device="meta"))
    assert sum(tk.LAUNCHES.values()) == 0
    # Ineligible QR shapes (D < N) take torch.linalg.qr.
    S = torch.from_numpy(rng.standard_normal((3, 2, 4)))
    Q, R = tqr.thin_qr(S.float())
    assert Q.shape == (3, 2, 2) and R.shape == (3, 2, 4)


def test_build_is_keyed_on_sources():
    # The library path is a pure function of the sources and flags; the
    # build itself needs nvcc and runs only on the GPU machine.
    p1, p2 = tk.library_path(), tk.library_path()
    assert p1 == p2 and p1.parent == tk.BUILD_DIR and p1.suffix == ".so"
    assert {s.name for s in tk.CSRC.glob("*.cu")} == {
        "cholesky.cu", "cho_solve.cu", "thin_qr.cu", "thin_qr_bf16.cu", "thin_qr_f64.cu", "masked_aat_cholesky.cu",
        "project_tangent.cu", "blocked_qr.cu", "graph_conditional.cu", "polyhedron_newton.cu",
        "polyhedron_newton_split.cu", "minor_direction_r.cu", "minor_loop_r.cu",
    }
    assert "--use_fast_math" not in tk.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS
    # Separately rounded products everywhere but in the panel QR, and the
    # choice is part of the key.
    assert not any(f.startswith("--fmad") for f in tk.NVCC_FLAGS) and tk.FMAD_SOURCES == ("blocked_qr.cu",)


# ---------------------------------------------------------------------------
# The fused call sites
# ---------------------------------------------------------------------------

FUSED_CASES = [(1, 3), (1, 192), (3, 37), (3, 192), (6, 37), (6, 192), (16, 37), (16, 192)]
FUSED_B = 6


def fused_inputs(rng, m, n, shared):
    """A (shared: one (m, n) matrix for the batch), a mask that keeps the
    first min(n - 1, 4m) columns free (a well-conditioned A Z Aᵀ, so that
    float32 summation order is all that differs), r, and two degenerate
    lanes: the last is all fixed, the one before has a single free column
    and entries of A in {±1, ±2} there, so that every product and sum is
    exact in any order and the NaN pattern does not hang on rounding."""
    B = FUSED_B
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    if shared:
        A = np.broadcast_to(rng.choice([-2.0, -1.0, 1.0, 2.0], (m, n)).astype(np.float32), (B, m, n))
    else:
        A[B - 2] = rng.choice([-2.0, -1.0, 1.0, 2.0], (m, n))
    fixed = rng.random((B, n)) < 0.3
    fixed[:, : min(n - 1, 4 * m)] = False
    fixed[B - 2] = True
    fixed[B - 2, 1] = False
    fixed[B - 1] = True
    r = rng.standard_normal((B, n)).astype(np.float32)
    return A, fixed, r


def torch_A(A, shared):
    """The port's operand: a stride-0 expand of one matrix when shared."""
    if shared:
        return torch.from_numpy(np.array(A[0])).expand(A.shape)
    return torch.from_numpy(A)


def assert_same_nan_close(got, want, scale):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("shared", [False, True], ids=["per_instance", "shared"])
@pytest.mark.parametrize("m,n", FUSED_CASES)
def test_masked_aat_cholesky_plain_matches_jax(m, n, shared, reg, rng):
    # Tolerance: rtol 1e-5 with atol 1e-5·max|L| — float32, the Gram sums
    # are taken in another order on the two sides.
    A, fixed, _ = fused_inputs(rng, m, n, shared)
    free = ~fixed
    At = torch_A(A, shared)
    L_t = tk.masked_aat_cholesky(At, torch.from_numpy(fixed), reg).numpy()
    # The op with the JAX package's signature (the free mask) is the same factor.
    np.testing.assert_array_equal(L_t, tchol.factor_masked_aat(At, torch.from_numpy(free), reg).numpy())
    assert L_t.shape == (FUSED_B, m, m) and np.all(np.triu(L_t, 1) == 0)

    # The call site under vmap (XLA's Cholesky on the CPU) on the regular lanes.
    a_axis = None if shared else 0
    jA = jnp.asarray(A[0] if shared else A)
    L_j = np.asarray(jax.vmap(lambda a, f: jchol.factor_masked_aat(a, f, reg), in_axes=(a_axis, 0))(jA, jnp.asarray(free)))
    good = slice(0, FUSED_B - 2)
    assert np.isfinite(L_t[good]).all()
    np.testing.assert_allclose(L_t[good], L_j[good], rtol=1e-5, atol=1e-5 * np.abs(L_j[good]).max())

    # Every lane, the degenerate ones too, against the Pallas kernel on the
    # same masked product (M = 16 takes the interpreter ~20 s; left out).
    if m <= 6:
        K = jax.vmap(jchol.masked_aat, in_axes=(a_axis, 0))(jA, jnp.asarray(free))
        K = K + jnp.float32(reg) * jnp.eye(m, dtype=jnp.float32)
        L_pl = np.asarray(jk.batched_cholesky(K, interpret=True))
        assert_same_nan_close(L_t, L_pl, np.abs(L_j[good]).max())
    if reg == 0.0 and m >= 3:
        # One free column under m equalities: the pivots after the first are
        # exactly 0, and the factor is NaN from the second column on.
        assert np.isnan(L_t[FUSED_B - 2, 2, 1]) and np.isnan(L_t[FUSED_B - 1, 1, 0])


@pytest.mark.parametrize("shared", [False, True], ids=["per_instance", "shared"])
@pytest.mark.parametrize("m,n", FUSED_CASES)
def test_project_tangent_plain_matches_jax(m, n, shared, rng):
    # Both sides get the same factor L; tolerance rtol 1e-5 with atol
    # 1e-5·max|r| (float32, dot products summed in another order).
    A, fixed, r = fused_inputs(rng, m, n, shared)
    At = torch_A(A, shared)
    L = tk.masked_aat_cholesky(At, torch.from_numpy(fixed))
    P_t = tk.project_tangent(At, L, torch.from_numpy(fixed), torch.from_numpy(r)).numpy()

    z = jnp.zeros((FUSED_B, n), jnp.float32)
    poly = jc.Polyhedron(jnp.asarray(A[0] if shared else A), jnp.zeros((FUSED_B, m), jnp.float32), z, z)
    axes = jc.Polyhedron(None if shared else 0, 0, 0, 0)
    aset = jc.ActiveSet(jnp.asarray(fixed), jnp.asarray(L.numpy()))
    P_j = np.asarray(jax.vmap(jpr.project_tangent, in_axes=(axes, jc.ActiveSet(0, 0), 0))(poly, aset, jnp.asarray(r)))
    good = slice(0, FUSED_B - 2)
    assert np.isfinite(P_t[good]).all()
    np.testing.assert_allclose(P_t[good], P_j[good], rtol=1e-5, atol=1e-5 * np.abs(r).max())
    assert np.all(P_t[fixed] == 0)
    # The all-fixed lane projects to zero whatever its factor holds.
    np.testing.assert_array_equal(P_t[FUSED_B - 1], np.zeros(n, np.float32))
    if m >= 3:
        # A NaN factor gives a NaN row on its free entries, as in JAX, and
        # nothing else.
        np.testing.assert_array_equal(np.isnan(P_t), np.isnan(P_j))
        assert np.isnan(P_t[FUSED_B - 2, 1]) and not np.isnan(P_t[FUSED_B - 2, 0])

    # The solve in the middle against the Pallas solve kernel, and the
    # unmasked output sigma = r - Aᵀw against the same composition.
    if m <= 6:
        free = ~fixed
        rz = np.where(free, r, 0).astype(np.float32)
        t = np.einsum("bmn,bn->bm", A, rz).astype(np.float32)
        ok = np.arange(FUSED_B - 2)
        w = np.asarray(jk.batched_cho_solve(jnp.asarray(L.numpy()[ok]), jnp.asarray(t[ok]), interpret=True))
        sigma = r[ok] - np.einsum("bmn,bm->bn", A[ok], w)
        S_t = tk.project_tangent(At, L, torch.from_numpy(fixed), torch.from_numpy(r), unmasked_output=True).numpy()
        scale = np.abs(r).max() + np.abs(sigma).max()
        np.testing.assert_allclose(S_t[ok], sigma, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(P_t[ok], np.where(free[ok], sigma, 0), rtol=1e-5, atol=1e-5 * scale)


def test_fused_dispatch_gate(rng):
    # CPU float32 -> the plain versions (no launch); float64 and m > 16 ->
    # the composition on torch.linalg; m = 0 -> no factor; a stride-0 A is
    # accepted as it is.
    tk.reset_launches()
    A, fixed, r = fused_inputs(rng, 3, 37, shared=True)
    A_sh = torch_A(A, shared=True)
    fx, rt = torch.from_numpy(fixed)[:4], torch.from_numpy(r)[:4]
    A_sh, A_pi = A_sh[:4], torch.from_numpy(A.copy())[:4]
    assert A_sh.stride(0) == 0 and tk.has_row_major_blocks(A_sh)
    assert tchol._row_major_blocks(A_sh) is A_sh           # no copy on the way to the kernel
    assert not tk.has_row_major_blocks(A_pi.mT.contiguous().mT)

    poly = tc.Polyhedron(A_sh, torch.zeros(4, 3), torch.zeros(4, 37), torch.zeros(4, 37))
    aset = tc.make_active_set(poly, fx)
    torch.testing.assert_close(aset.chol, tk.masked_aat_cholesky_plain(A_pi, fx), rtol=0, atol=0)
    torch.testing.assert_close(
        tpr.project_tangent(poly, aset, rt), tk.project_tangent_plain(A_pi, aset.chol, fx, rt), rtol=0, atol=0
    )
    torch.testing.assert_close(tchol.factor_masked_aat(A_sh, ~fx), aset.chol, rtol=0, atol=0)

    # float64: the library route, same numbers to float32 accuracy.
    poly64 = tc.Polyhedron(*[f.double() for f in poly])
    aset64 = tc.make_active_set(poly64, fx)
    assert aset64.chol.dtype == torch.float64
    np.testing.assert_allclose(aset64.chol.numpy(), aset.chol.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tpr.project_tangent(poly64, aset64, rt.double()).numpy(), tpr.project_tangent(poly, aset, rt).numpy(),
        rtol=1e-4, atol=1e-5,
    )
    # m = 20 > 16: torch.linalg in float32.
    A20 = torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(np.float32))
    free20 = torch.ones((2, 64), dtype=torch.bool)
    np.testing.assert_allclose(
        tchol.factor_masked_aat(A20, free20).numpy(), np.linalg.cholesky((A20 @ A20.mT).numpy()), rtol=1e-4, atol=1e-4
    )
    # The gate is the old kernels' (m, dtype) test; n does not enter it.
    assert tchol._fused_eligible(torch.zeros((2, 3, 5000)).expand(2, 3, 5000))
    assert tchol._fused_eligible(torch.zeros((2, 16, 8)))
    assert not tchol._fused_eligible(torch.zeros((2, 3, 8), dtype=torch.float64))
    assert not tchol._fused_eligible(torch.zeros((2, 17, 32)))
    # m = 0: an empty factor, and the projection only masks.
    poly0 = tc.Polyhedron(torch.zeros(4, 0, 37), torch.zeros(4, 0), poly.xl, poly.xu)
    aset0 = tc.make_active_set(poly0, fx)
    assert aset0.chol.shape == (4, 0, 0)
    torch.testing.assert_close(tpr.project_tangent(poly0, aset0, rt), torch.where(fx, 0.0, rt), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tk.project_tangent(torch.zeros(4, 0, 37), torch.zeros(4, 0, 0), fx, rt)
    # Empty batch and refused operands.
    assert tk.masked_aat_cholesky(torch.zeros(0, 3, 5), torch.zeros(0, 5, dtype=torch.bool)).shape == (0, 3, 3)
    assert tk.project_tangent(
        torch.zeros(0, 3, 5), torch.zeros(0, 3, 3), torch.zeros(0, 5, dtype=torch.bool), torch.zeros(0, 5)
    ).shape == (0, 5)
    with pytest.raises(ValueError):
        tk.masked_aat_cholesky(A_pi, fx[:, :5])
    with pytest.raises(ValueError):
        tk.masked_aat_cholesky(A_pi.to("meta"), fx.to("meta"))
    assert sum(tk.LAUNCHES.values()) == 0 and set(tk.LAUNCHES) == {
        "batched_cholesky", "batched_cho_solve", "batched_thin_qr", "narrow_qr_r", "masked_aat_cholesky",
        "project_tangent", "blocked_qr_r", "polyhedron_newton", "minor_direction_r", "minor_loop_r",
    }


def test_coupled_binding_uses_one_factor_and_one_projection(monkeypatch, rng):
    # `binding_bounds_coupled` goes through the two fused wrappers once per
    # pass (one launch each on the card) and gives the JAX answer.
    calls = {"factor": 0, "project": 0}
    real_f, real_p = tk.masked_aat_cholesky, tk.project_tangent

    def count_f(*a, **k):
        calls["factor"] += 1
        return real_f(*a, **k)

    def count_p(*a, **k):
        calls["project"] += 1
        return real_p(*a, **k)

    monkeypatch.setattr(tk, "masked_aat_cholesky", count_f)
    monkeypatch.setattr(tk, "project_tangent", count_p)
    B, m, n = 8, 2, 7
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    x = rng.standard_normal((B, n)).astype(np.float32)
    xl, xu = x - 0.5, x + 0.5
    on = rng.random((B, n)) < 0.4
    on[:, : m + 1] = False
    x = np.where(on, xl, x).astype(np.float32)
    g = rng.standard_normal((B, n)).astype(np.float32)
    b = np.einsum("bmn,bn->bm", A, x).astype(np.float32)
    tp = tc.Polyhedron(*[torch.from_numpy(v) for v in (A, b, xl, xu)])
    fixed_t = tc.binding_bounds_coupled(tp, torch.from_numpy(x), torch.from_numpy(g), 1e-6, passes=2)
    assert calls == {"factor": 2, "project": 2}
    jp = jc.Polyhedron(*[jnp.asarray(v) for v in (A, b, xl, xu)])
    fixed_j = jax.vmap(lambda p, xx, gg: jc.binding_bounds_coupled(p, xx, gg, 1e-6, passes=2),
                       in_axes=(jc.Polyhedron(0, 0, 0, 0), 0, 0))(jp, jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_array_equal(fixed_t.numpy(), np.asarray(fixed_j))


# ---------------------------------------------------------------------------
# The panel QR (R only, 16 < N)
# ---------------------------------------------------------------------------

EPS32 = float(np.finfo(np.float32).eps)


def jax_r(S):
    """The JAX package's R under vmap (XLA's Householder at N > 16), rows
    turned so that the diagonal is positive."""
    R = np.asarray(jax.vmap(jqr.qr_r)(jnp.asarray(S)))
    d = np.diagonal(R, axis1=1, axis2=2)
    return R * np.where(d < 0, -1.0, 1.0)[:, :, None].astype(R.dtype)


def assert_r_factor(R, S, kappa=None):
    """R is upper triangular with a positive diagonal; RᵀR = SᵀS to 2·N·eps
    (Frobenius, relative, products in float64); R agrees with the JAX R to
    4·eps·(√D + κ)·max|R|: both are backward stable, so each is within
    c·κ(S)·eps of the exact factor, and √D·eps is the rounding of a column
    norm over D rows.  κ is taken from the JAX R unless given."""
    B, D, N = S.shape
    assert R.shape == (B, N, N) and np.all(np.tril(R, -1) == 0)
    assert np.all(np.diagonal(R, axis1=1, axis2=2) > 0)
    Sd, Rd = S.astype(np.float64), R.astype(np.float64)
    G = np.einsum("bdi,bdj->bij", Sd, Sd)
    gram = np.linalg.norm(np.einsum("bki,bkj->bij", Rd, Rd) - G, axis=(1, 2)) / np.linalg.norm(G, axis=(1, 2))
    assert gram.max() <= 2 * N * EPS32, gram.max()
    R_j = jax_r(S)
    if kappa is None:
        kappa = np.linalg.cond(R_j.astype(np.float64)).max()
    tol = 4 * EPS32 * (np.sqrt(D) + kappa) * np.abs(R_j).max()
    assert np.abs(R - R_j).max() <= tol, (np.abs(R - R_j).max(), tol, kappa)


@pytest.mark.parametrize("D", ["N", "3N", 1216])
@pytest.mark.parametrize("N", [17, 40, 96, 192])
def test_blocked_qr_r_plain_matches_jax(N, D, rng):
    # N = 17 is one ragged panel, 40 and 96 a full panel and a ragged or full
    # last one, 192 six panels; D = N is square (κ up to ~1e3 for a Gaussian
    # matrix), D = 1216 the polish's row count on config 3.
    D = {"N": N, "3N": 3 * N}.get(D, D)
    S = rng.standard_normal((4, D, N)).astype(np.float32)
    S0 = S.copy()
    R = tk.blocked_qr_r(torch.from_numpy(S)).numpy()
    np.testing.assert_array_equal(S, S0)       # S is not written
    assert_r_factor(R, S)
    # `qr_r` takes this route for a float32 CPU tensor at 16 < N.
    np.testing.assert_array_equal(tqr.qr_r(torch.from_numpy(S)).numpy(), R)


def polish_stack(rng, B, d, n, reg):
    """[JZ; D] as the polish's factor step builds it: zero columns where a
    bound is fixed over diag(fixed ? 1 : sqrt(reg))."""
    fixed = rng.random((B, n)) < 0.2
    JZ = rng.standard_normal((B, d, n)) * ~fixed[:, None, :]
    dbot = np.where(fixed, 1.0, np.sqrt(reg))
    return np.concatenate([JZ, dbot[:, :, None] * np.eye(n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("reg", [0.0, 1e-8])
def test_blocked_qr_r_plain_polish_shaped(reg, rng):
    # Column count 70: two full panels and a ragged one; d + n = 230 rows.
    S = polish_stack(rng, 4, 160, 70, reg)
    assert_r_factor(tk.blocked_qr_r(torch.from_numpy(S)).numpy(), S)


def conditioned(rng, B, D, N, kappa):
    """(B, D, N) float32 with singular values spaced geometrically from 1 to 1/κ."""
    U = np.linalg.qr(rng.standard_normal((B, D, N)))[0]
    V = np.linalg.qr(rng.standard_normal((B, N, N)))[0]
    return ((U * np.logspace(0.0, -np.log10(kappa), N)) @ np.transpose(V, (0, 2, 1))).astype(np.float32)


def chord_contraction(S, R):
    """max over the batch of ‖R⁻ᵀ(SᵀS − RᵀR)R⁻¹‖₂ (in float64): the
    contraction of the polish's chord step built on R."""
    Sd, Rd = S.astype(np.float64), R.astype(np.float64)
    E = np.einsum("bdi,bdj->bij", Sd, Sd) - np.einsum("bki,bkj->bij", Rd, Rd)
    Rinv = np.linalg.inv(Rd)
    return np.linalg.norm(np.transpose(Rinv, (0, 2, 1)) @ E @ Rinv, 2, axis=(1, 2)).max()


@pytest.mark.parametrize("kappa", [1e2, 1e4])
def test_blocked_qr_r_plain_ill_conditioned(kappa, rng):
    # Besides the forward tolerance (4·eps·κ·max|R|), the factor must be
    # good for the chord iteration: ‖R⁻ᵀ(SᵀS − RᵀR)R⁻¹‖₂ ≤ 8·κ·eps, the
    # contraction a backward-stable R gives; a Cholesky factor of SᵀS gives
    # κ²·eps, no contraction at all at κ = 1e4 in float32.
    S = conditioned(rng, 3, 300, 70, kappa)
    R = tk.blocked_qr_r(torch.from_numpy(S)).numpy()
    assert_r_factor(R, S, kappa=kappa)
    contraction = chord_contraction(S, R)
    assert contraction <= 8 * kappa * EPS32, contraction


@pytest.mark.parametrize("kappa", [1e4, 1e5, 1e6])
@pytest.mark.parametrize("N", [36, 40, 48, 70, 100, 136])
def test_blocked_qr_r_plain_ragged_panel_matches_householder(N, kappa, rng):
    # N not a multiple of the panel width: at the float32 width of 64 the
    # last panel holds 36, 40, 48, 6, 36 or 8 columns (at the width of 32
    # before it, 4, 8, 16, 6, 4 and 8).  With one projection pass against the finished
    # panels the contraction reached 1e2·κ·eps here; with two passes but
    # without the CholeskyQR step on each finished panel (whose modified
    # Gram–Schmidt Q is orthonormal only to κ(panel)·eps) it reached
    # 8·κ·eps at κ = 1e6.  It must stay under 2·κ·eps, a bound the JAX
    # package's Householder R meets with room to spare (checked on the same
    # S).  R against the JAX R under assert_r_factor's tolerance,
    # 4·eps·(√D + κ)·max|R|.
    S = conditioned(rng, 4, 300, N, kappa)
    R = tk.blocked_qr_r(torch.from_numpy(S)).numpy()
    assert_r_factor(R, S, kappa=kappa)
    contraction = chord_contraction(S, R)
    assert contraction <= 2 * kappa * EPS32, contraction / (kappa * EPS32)
    householder = chord_contraction(S, jax_r(S))
    assert householder <= 2 * kappa * EPS32, householder / (kappa * EPS32)


@pytest.mark.parametrize("kappa", [1e5, 1e6])
def test_blocked_qr_r_plain_contraction_over_seeded_draws(kappa):
    # The 40 draws of scripts/blocked_qr_contraction.py at (4, 300, 36): at
    # κ = 1e5 one of them reached 3.5·κ·eps with two projection passes and
    # no reorthogonalization of the finished panels, at κ = 1e6 all of them
    # about 8·κ·eps.  Every draw must stay under 2·κ·eps.
    rng = np.random.default_rng([0, 36, int(kappa)])
    worst = 0.0
    for _ in range(40):
        U = np.linalg.qr(rng.standard_normal((4, 300, 36)))[0]
        V = np.linalg.qr(rng.standard_normal((4, 36, 36)))[0]
        S = ((U * np.logspace(0.0, -np.log10(kappa), 36)) @ np.transpose(V, (0, 2, 1))).astype(np.float32)
        worst = max(worst, chord_contraction(S, tk.blocked_qr_r(torch.from_numpy(S)).numpy()))
    assert worst <= 2 * kappa * EPS32, worst / (kappa * EPS32)


def test_blocked_qr_r_plain_singular_panel_gram_keeps_r2_identity(rng, monkeypatch):
    # A zero column in the first panel (of two at the float32 panel width
    # 64: only the first is reused) makes that panel's Gram QᵀQ singular:
    # its CholeskyQR step keeps R₂ = I, so the lane's R is the one of two
    # passes without the step (every Cholesky forced to fail gives that R),
    # finite, with the sqrt(tiny) floor on the diagonal.  The healthy lanes
    # are reorthogonalized.
    S = rng.standard_normal((3, 120, 80)).astype(np.float32)
    S[1, :, 5] = 0.0
    St = torch.from_numpy(S)
    R = tk.blocked_qr_r(St)
    cholesky_ex = torch.linalg.cholesky_ex
    monkeypatch.setattr(torch.linalg, "cholesky_ex",
                        lambda G: (cholesky_ex(G)[0], torch.ones(G.shape[:-2], dtype=torch.int32)))
    R_no_step = tk.blocked_qr_r(St)
    assert torch.isfinite(R).all()
    assert torch.equal(R[1], R_no_step[1])
    assert not torch.equal(R[0], R_no_step[0]) and not torch.equal(R[2], R_no_step[2])
    np.testing.assert_allclose(float(R[1, 5, 5]), np.sqrt(np.finfo(np.float32).tiny), rtol=1e-6)
    assert_r_factor(R[[0, 2]].numpy(), S[[0, 2]])


def test_blocked_qr_r_plain_zero_column_and_nan_lane(rng):
    # A zero column is floored at sqrt(tiny) on the diagonal (the narrow
    # kernel's floor) with zeros beside it; a NaN stays in its own instance.
    S = rng.standard_normal((4, 90, 40)).astype(np.float32)
    S[1, :, 35] = 0.0
    S[3, 7, 2] = np.nan
    R = tk.blocked_qr_r(torch.from_numpy(S)).numpy()
    floor = np.sqrt(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(R[1, 35, 35], floor, rtol=1e-6)
    assert np.all(R[1, 35, 36:] == 0) and np.all(R[1, :35, 35] == 0)
    assert np.isfinite(R[[0, 1, 2]]).all() and np.isnan(R[3]).any()
    assert_r_factor(R[[0, 2]], S[[0, 2]])
    # The narrow kernel's plain version has the same floor.
    assert tk.batched_thin_qr(torch.zeros((1, 4, 2)))[1][0, 0, 0] == np.float32(floor)


QR_ROUTES = [
    # shape, dtype, route
    ((2, 35, 3), torch.float32, "narrow_qr_r"),
    ((2, 40, 16), torch.float32, "narrow_qr_r"),
    ((4, 40, 17), torch.float32, "blocked_qr_r"),
    ((4, 300, 256), torch.float32, "blocked_qr_r"),
    ((4, 2048, 20), torch.float32, "blocked_qr_r"),
    ((3, 40, 17), torch.float32, "linalg"),
    ((4, 300, 257), torch.float32, "linalg"),
    ((4, 2049, 20), torch.float32, "linalg"),
    ((4, 20, 40), torch.float32, "linalg"),
    ((4, 40, 17), torch.float64, "linalg"),
    ((40, 17), torch.float32, "linalg"),
]


@pytest.mark.parametrize("shape,dtype,route", QR_ROUTES, ids=lambda v: str(v).replace("torch.", ""))
def test_qr_r_gate(shape, dtype, route, monkeypatch, rng):
    # Which wrapper `qr_r` hands a CPU tensor to: the narrow kernel's R-only
    # form at N ≤ 16, the panel kernel's at 16 < N ≤ 256 and a batch of 4 or
    # more, both float32 with N ≤ D ≤ 2048; torch.linalg.qr otherwise.
    # `thin_qr` (Q wanted) takes the narrow kernel's Q and R form, never the
    # panel kernel.
    calls = []
    for name in ("batched_thin_qr", "narrow_qr_r", "blocked_qr_r"):
        orig = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda S, _o=orig, _n=name: calls.append(_n) or _o(S))
    S = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    R = tqr.qr_r(S)
    assert calls == ([] if route == "linalg" else [route])
    K = min(shape[-2:])
    assert R.shape == shape[:-2] + (K, shape[-1]) and R.dtype == dtype
    calls.clear()
    Q, R2 = tqr.thin_qr(S)
    assert calls == (["batched_thin_qr"] if route == "narrow_qr_r" else [])
    torch.testing.assert_close(Q @ R2, S, rtol=1e-4, atol=1e-4)


def test_blocked_qr_r_wrapper_contract():
    # Plan rule: the fewest blocks a cluster whose row slices hold at most
    # 640 rows, each slice padded to 16 rows, leading dimension 4 mod 32;
    # panels of 64 columns in float32, 32 in float64.
    f32, f64 = torch.float32, torch.float64
    assert tk.blocked_qr_plan(1216, 192, f32) == (2, 64, 608, 612) and tk.blocked_qr_plan(1540, 70, f32) == (4, 64, 400, 420)
    assert tk.blocked_qr_plan(2048, 256, f32) == (4, 64, 512, 516) and tk.blocked_qr_plan(534, 150, f32) == (1, 64, 544, 548)
    assert tk.blocked_qr_plan(2048, 40, f64) == (4, 32, 512, 516) and tk.blocked_qr_plan(17, 17, f32) == (1, 64, 32, 36)
    assert tk.blocked_qr_plan(10 ** 6, 20, f32) is None and tk.blocked_qr_plan(300, 20, torch.bfloat16) is None
    # Empty batches and refused operands; nothing on the CPU counts as a launch.
    tk.reset_launches()
    assert tk.blocked_qr_r(torch.zeros((0, 50, 20))).shape == (0, 20, 20)
    assert tk.blocked_qr_r(torch.zeros((3, 50, 0))).shape == (3, 0, 0)
    with pytest.raises(ValueError):
        tk.blocked_qr_r(torch.zeros((2, 20, 50)))           # D < N
    with pytest.raises(ValueError):
        tk.blocked_qr_r(torch.zeros((50, 20)))              # no batch
    # A tensor that is on neither the CPU nor a CUDA device is refused, and
    # the launch path refuses a CPU tensor and a missing library: it raises,
    # it never falls back to the plain version.
    with pytest.raises(ValueError):
        tk.blocked_qr_r(torch.zeros((2, 50, 20), device="meta"))
    with pytest.raises(ValueError):
        tk._require_cuda("blocked_qr_r", torch.zeros((2, 50, 20)))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, OSError, AssertionError)):
            tk._launch("blocked_qr_r", "benlsip_blocked_qr_r", torch.zeros((2, 50, 20)), 0, None, 0, 0, 2, 50, 20, 1, 64, 68)
    assert tk.LAUNCHES["blocked_qr_r"] == 0
