"""The plain PyTorch versions of the CUDA kernels (benlsip_tpu_torch/kernels)
against the Pallas kernels they replace, run in interpret mode.

Same cases as tests/test_kernels.py (B = 200/130/140, not lane-aligned),
plus the empty batches, the NaN-on-non-SPD contract and the dispatch gate.
Inputs are float32 from a seeded numpy generator and go through both.
Tolerance 1e-5 (relative, atol 1e-5): both sides run the same algorithm in
the same order, so they differ only by float32 rounding of the reductions.
The kernels themselves compile and run only on the GPU; chip_smoke.py holds
them against these plain versions there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.kernels import batched_linalg as jk
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import cholesky as tchol
from benlsip_tpu_torch.ops import qr as tqr

torch.set_num_threads(2)
rng = np.random.default_rng(3)
TOL = dict(rtol=1e-5, atol=1e-5)


def spd_batch(B, M, dtype=np.float32):
    A = rng.standard_normal((B, M, M)).astype(dtype)
    return A @ np.transpose(A, (0, 2, 1)) + M * np.eye(M, dtype=dtype)


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_cholesky_plain_matches_pallas(M):
    K = spd_batch(200, M)
    L_pl = np.asarray(jk.batched_cholesky(jnp.asarray(K), interpret=True))
    L_t = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L_t, L_pl, **TOL)
    assert np.all(np.triu(L_t, 1) == 0)


@pytest.mark.parametrize("M", [1, 3, 6])
def test_cho_solve_plain_matches_pallas(M):
    K = spd_batch(130, M)
    L = np.linalg.cholesky(K).astype(np.float32)
    b = rng.standard_normal((130, M)).astype(np.float32)
    x_pl = np.asarray(jk.batched_cho_solve(jnp.asarray(L), jnp.asarray(b), interpret=True))
    x_t = tk.batched_cho_solve(torch.from_numpy(L), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x_t, x_pl, rtol=1e-5, atol=1e-5 * np.abs(x_pl).max())


def test_largest_factor_matches_lapack():
    # M = 16, the kernels' upper bound, against LAPACK (the Pallas
    # interpreter takes ~20 s at this size).  Tolerance 2e-5: float32
    # rounding of an O(M) accumulation, different order from LAPACK's.
    K = spd_batch(64, 16)
    L = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), rtol=2e-5, atol=2e-5)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    x = tk.batched_cho_solve(torch.from_numpy(L), torch.from_numpy(b)).numpy()
    x_ref = np.linalg.solve(K.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,N", [(8, 3), (32, 3), (16, 8), (35, 3), (3, 1)])
def test_thin_qr_plain_matches_pallas(D, N):
    A = rng.standard_normal((140, D, N)).astype(np.float32)
    Q_pl, R_pl = jk.batched_thin_qr(jnp.asarray(A), interpret=True)
    Q_t, R_t = tk.batched_thin_qr(torch.from_numpy(A))
    np.testing.assert_allclose(Q_t.numpy(), np.asarray(Q_pl), **TOL)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_pl), rtol=1e-5, atol=1e-5 * np.sqrt(D))
    R = R_t.numpy()
    assert np.all(np.tril(R, -1) == 0) and np.all(np.diagonal(R, axis1=1, axis2=2) > 0)


def test_non_spd_pivot_gives_nan_like_pallas():
    # No clamping: a negative pivot is NaN in both; the earlier columns
    # stay finite.
    K = spd_batch(4, 3)
    K[1, 2, 2] = -50.0
    L_pl = np.asarray(jk.batched_cholesky(jnp.asarray(K), interpret=True))
    L_t = tk.batched_cholesky(torch.from_numpy(K)).numpy()
    assert np.isnan(L_t[1, 2, 2]) and np.isnan(L_pl[1, 2, 2])
    np.testing.assert_array_equal(np.isnan(L_t), np.isnan(L_pl))
    assert np.isfinite(L_t[[0, 2, 3]]).all()


def test_zero_column_qr_floors_at_tiny():
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


def test_dispatch_gate():
    # Eligible float32 CPU tensors run the plain version (no launch), f64
    # and M > 16 go to torch.linalg, bf16 is not ported, and a tensor on a
    # device that is neither cpu nor cuda is refused by the wrappers.
    tk.reset_launches()
    K32 = torch.from_numpy(spd_batch(7, 3))
    np.testing.assert_allclose(
        tchol.cholesky(K32).numpy(), tk.batched_cholesky_plain(K32).numpy(), rtol=0, atol=0
    )
    K64 = K32.double()
    np.testing.assert_allclose(
        tchol.cholesky(K64).numpy(), np.linalg.cholesky(K64.numpy()), rtol=1e-12
    )
    K20 = torch.from_numpy(spd_batch(2, 20))
    np.testing.assert_allclose(
        tchol.cholesky(K20).numpy(), np.linalg.cholesky(K20.numpy()), rtol=1e-4, atol=1e-5
    )
    # Non-PD through the library route: LAPACK's NaN signal, not an exception.
    bad = K64.clone()
    bad[0] = -torch.eye(3, dtype=torch.float64)
    Lb = tchol.cholesky(bad)
    assert torch.isnan(Lb[0]).all() and torch.isfinite(Lb[1:]).all()
    with pytest.raises(NotImplementedError):
        tchol.cholesky(K32.to(torch.bfloat16))
    with pytest.raises(NotImplementedError):
        tqr.qr_r(torch.zeros((2, 4, 2), dtype=torch.bfloat16))
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
    assert {s.name for s in tk.CSRC.glob("*.cu")} == {"cholesky.cu", "cho_solve.cu", "thin_qr.cu"}
    assert "--use_fast_math" not in tk.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS
