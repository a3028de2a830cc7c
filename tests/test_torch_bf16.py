"""bfloat16 in the port's small kernels, against the JAX package's Pallas
kernels and call sites on the same bf16 inputs.

The five small kernels take bf16 as the TPU kernels do.  A bf16 kernel on
the card computes in float32 and rounds each output once, so its plain
version (what a CPU tensor runs) is the float32 plain version on the
upcast inputs, rounded once.  The Pallas kernels in interpret mode round
every operation to bf16 instead, so they are the reference at bf16 grade:
|Δ| ≤ 2·M·2⁻⁸·max|out| per instance (M the factor's or the QR's column
count).  Against the JAX package's float32 round trips (`_chol_xla`,
`_xla_qr`), which compute what the port's plain versions compute, the
gate is one bf16 ulp of each entry (plus float32 rounding for QR, whose
Householder and Gram–Schmidt differ in the last float32 bits).

The ops around the kernels and the bf16 pipeline are held in
tests/test_torch_bf16_pipeline.py.  Inputs are float32 from a seeded numpy generator, rounded to bf16 once
and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.kernels import batched_linalg as jk
from benlsip_tpu.ops import cholesky as jchol
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import project as jpr
from benlsip_tpu.ops import qr as jqr
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import cholesky as tchol
from benlsip_tpu_torch.ops import qr as tqr

torch.set_num_threads(2)
rng = np.random.default_rng(11)
BF = torch.bfloat16
EPS32 = float(np.finfo(np.float32).eps)


def bf16(a) -> np.ndarray:
    """a rounded once to bf16, held as float32 (what both packages get)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def t_bf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def j_bf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def f32(a) -> np.ndarray:
    """A bf16 tensor or array of either package as a float32 array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def spd(B, M):
    A = rng.standard_normal((B, M, M))
    return bf16(A @ np.transpose(A, (0, 2, 1)) + M * np.eye(M))


def assert_bf16_grade(got, want, M):
    """|Δ| ≤ 2·M·2⁻⁸·max|out| in every instance (axis 0)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    B = got.shape[0]
    err = np.abs(got - want).reshape(B, -1).max(1)
    scale = np.abs(want).reshape(B, -1).max(1)
    assert np.all(err <= 2 * M * 2.0 ** -8 * scale), (err / scale).max()


def bf16_ulp(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def assert_within_one_ulp(got, want, f32_scale=0.0):
    got, want = f32(got), f32(want)
    slack = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 8 * EPS32 * f32_scale
    assert np.all(np.abs(got - want) <= slack), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels, in bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 3, 6, 16])
def test_cholesky_and_solve_bf16_match_pallas(M):
    K = spd(8, M)
    L_pl = jk.batched_cholesky(j_bf(K), interpret=True)
    L_t = tk.batched_cholesky(t_bf(K))
    assert L_t.dtype == BF and L_pl.dtype == jnp.bfloat16
    assert_bf16_grade(L_t, L_pl, M)
    assert np.all(np.triu(f32(L_t), 1) == 0)
    # The plain version is the float32 plain version rounded once, which is
    # the JAX package's own float32 round trip to the last bit here.
    np.testing.assert_array_equal(f32(L_t), f32(tk.batched_cholesky_plain(torch.from_numpy(K)).to(BF)))
    assert_within_one_ulp(L_t, jchol._chol_xla(j_bf(K)))

    b = bf16(rng.standard_normal((8, M)))
    L = f32(L_pl)
    x_pl = jk.batched_cho_solve(j_bf(L), j_bf(b), interpret=True)
    x_t = tk.batched_cho_solve(t_bf(L), t_bf(b))
    assert x_t.dtype == BF
    assert_bf16_grade(x_t, x_pl, M)
    np.testing.assert_array_equal(f32(x_t), f32(tk.batched_cho_solve_plain(torch.from_numpy(L), torch.from_numpy(b)).to(BF)))


def test_non_spd_pivot_bf16_nan_in_its_own_instance():
    K = spd(4, 3)
    K[1, 2, 2] = -50.0
    L_pl = f32(jk.batched_cholesky(j_bf(K), interpret=True))
    L_t = f32(tk.batched_cholesky(t_bf(K)))
    assert np.isnan(L_t[1, 2, 2]) and np.isnan(L_pl[1, 2, 2])
    np.testing.assert_array_equal(np.isnan(L_t), np.isnan(L_pl))
    assert np.isfinite(L_t[[0, 2, 3]]).all()


@pytest.mark.parametrize("D,N", [(35, 3), (3, 1), (7, 3), (192, 6)])
def test_thin_qr_bf16_matches_pallas(D, N):
    A = bf16(rng.standard_normal((8, D, N)))
    Q_pl, R_pl = jk.batched_thin_qr(j_bf(A), interpret=True)
    Q_t, R_t = tk.batched_thin_qr(t_bf(A))
    assert Q_t.dtype == R_t.dtype == BF
    assert_bf16_grade(Q_t, Q_pl, N)
    assert_bf16_grade(R_t, R_pl, N)
    R = f32(R_t)
    assert np.all(np.tril(R, -1) == 0) and np.all(np.diagonal(R, axis1=1, axis2=2) > 0)
    # Against the JAX float32 round trip (Householder), signs normalised so
    # that R has a positive diagonal.
    Q_x, R_x = (f32(t) for t in jax.vmap(lambda a: jqr._xla_qr(a, "reduced"))(j_bf(A)))
    sign = np.sign(np.diagonal(R_x, axis1=1, axis2=2))
    assert_within_one_ulp(R_t, R_x * sign[:, :, None], np.abs(R_x).max())
    assert_within_one_ulp(Q_t, Q_x * sign[:, None, :], 1.0)


def test_zero_column_bf16_qr_floors_at_tiny():
    # bf16 and float32 share the exponent range, so the floor is float32's.
    assert torch.finfo(BF).tiny == torch.finfo(torch.float32).tiny
    A = bf16(rng.standard_normal((5, 6, 2)))
    A[2, :, 1] = 0.0
    Q_pl, R_pl = jk.batched_thin_qr(j_bf(A), interpret=True)
    Q_t, R_t = tk.batched_thin_qr(t_bf(A))
    assert np.isfinite(f32(Q_t)).all() and np.isfinite(f32(R_t)).all()
    assert_bf16_grade(R_t, R_pl, 2)
    assert_bf16_grade(Q_t, Q_pl, 2)


FUSED_BF16 = [(8, 1, 3, False), (4, 6, 192, True)]


def fused_bf16(B, m, n, shared):
    A = bf16(rng.standard_normal((m, n) if shared else (B, m, n)))
    fixed = rng.random((B, n)) < 0.3
    fixed[:, : min(n - 1, 4 * m)] = False
    r = bf16(rng.standard_normal((B, n)))
    At = t_bf(A).expand(B, m, n) if shared else t_bf(A)
    return A, At, fixed, r


@pytest.mark.parametrize("B,m,n,shared", FUSED_BF16)
def test_fused_bf16_match_jax_call_sites(B, m, n, shared):
    A, At, fixed, r = fused_bf16(B, m, n, shared)
    L_t = tk.masked_aat_cholesky(At, torch.from_numpy(fixed), 1e-3)
    assert L_t.dtype == BF and (At.stride(0) == 0) == shared
    a_axis = None if shared else 0
    L_j = jax.vmap(lambda a, f: jchol.factor_masked_aat(a, f, 1e-3), in_axes=(a_axis, 0))(
        j_bf(A), jnp.asarray(~fixed))
    assert L_j.dtype == jnp.bfloat16
    assert_bf16_grade(L_t, L_j, m)
    np.testing.assert_array_equal(
        f32(L_t), f32(tk.masked_aat_cholesky_plain(torch.from_numpy(A).expand(B, m, n) if shared
                                                   else torch.from_numpy(A), torch.from_numpy(fixed), 1e-3).to(BF)))

    # Both sides project with the same bf16 factor.
    L = f32(L_j)
    P_t = tk.project_tangent(At, t_bf(L), torch.from_numpy(fixed), t_bf(r))
    z = jnp.zeros((B, n), jnp.bfloat16)
    poly = jc.Polyhedron(j_bf(A), jnp.zeros((B, m), jnp.bfloat16), z, z)
    axes = jc.Polyhedron(a_axis, 0, 0, 0)
    aset = jc.ActiveSet(jnp.asarray(fixed), j_bf(L))
    P_j = jax.vmap(jpr.project_tangent, in_axes=(axes, jc.ActiveSet(0, 0), 0))(poly, aset, j_bf(r))
    assert P_t.dtype == BF and P_j.dtype == jnp.bfloat16
    assert np.all(f32(P_t)[fixed] == 0)
    # The projection's entries are differences of O(|r|) terms: bf16 grade
    # of max|r| per instance.
    err = np.abs(f32(P_t) - f32(P_j)).max(1)
    assert np.all(err <= 2 * m * 2.0 ** -8 * np.abs(r).max(1) * np.sqrt(n)), err


def test_bf16_wrappers_on_the_cpu_and_the_gates():
    # bf16 CPU tensors run the plain versions: no launch of any dtype.
    tk.reset_launches()
    A, At, fixed, r = fused_bf16(8, 1, 3, False)
    L = tchol.factor_unfixed_aat(At, torch.from_numpy(fixed))
    P = tchol.masked_projection(At, L, torch.from_numpy(fixed), t_bf(r))
    x = tchol.cho_solve_lower(L, t_bf(rng.standard_normal((8, 1))))
    assert L.dtype == P.dtype == x.dtype == BF
    assert sum(tk.LAUNCHES.values()) == 0 and not tk.LAUNCHES_BY_DTYPE
    # The gates admit bf16 for the small kernels at 0 < M ≤ 16.
    assert tchol._kernel_eligible(3, BF) and tchol._kernel_eligible(16, BF) and not tchol._kernel_eligible(17, BF)
    assert tqr._kernel_eligible(torch.zeros((2, 8, 3), dtype=BF))
    # M > 16 and the library routes: a float32 round trip, as JAX's `_chol_xla`.
    K20 = spd(2, 20)
    np.testing.assert_array_equal(f32(tchol.cholesky(t_bf(K20))),
                                  f32(torch.linalg.cholesky(torch.from_numpy(K20)).to(BF)))
    bad = t_bf(-np.eye(3)[None])
    assert torch.isnan(tchol.chol_linalg(bad).float()).all()
    # The panel QR kernel has no bf16: a wide bf16 qr_r is the float32
    # route rounded once, and the wrapper itself refuses bf16 on either device.
    S = t_bf(rng.standard_normal((4, 64, 32)))
    R = tqr.qr_r(S)
    assert R.dtype == BF
    np.testing.assert_array_equal(f32(R), f32(tqr.qr_r(S.float()).to(BF)))
    with pytest.raises(TypeError):
        tk.blocked_qr_r(S)
    with pytest.raises(ValueError):
        tk.batched_cholesky(torch.zeros((2, 3, 3), dtype=BF, device="meta"))
