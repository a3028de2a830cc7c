"""The split form of the two fused kernels (a thread-block cluster per
instance for large n), on the CPU.

The kernels themselves run only on the card (chip_smoke.py phase 3 holds the
split form against the plain versions there, bitwise lane by lane and call
by call).  Here: the plan that picks the form is a function of (m, n, dtype)
and never of the batch, the wrappers hand it to the C entry points, whose
signatures carry it, and a CPU call counts no launch; and the plain versions
at config 4's width (n = 10,240 and a ragged 10,277) against the JAX
package's call sites under jax.vmap, `ops/cholesky.factor_masked_aat` and
`ops/project.project_tangent` (XLA on the CPU), with a regular and a
degenerate lane.  Inputs are float32 from a seeded numpy generator.
Tolerance: rtol 1e-5, atol 1e-7·√n·max|L| for the factor and 1e-7·√n·max|r|
for the projection (float32 sums of n terms taken in another order).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.kernels import batched_linalg as jk
from benlsip_tpu.ops import cholesky as jchol
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import project as jpr
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import cholesky as tchol

torch.set_num_threads(2)
DTYPES = [torch.float32, torch.float64, torch.bfloat16]
CONFIG4 = (8, 10240)   # (m, n) of config 4's one instance


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 37, 192])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_keeps_the_warp_form_at_the_small_paths(n, dtype):
    # Configs 1, 2, 3 and 5 have n <= 192: one warp per instance, as before.
    assert [tk.fused_plan(M, n, dtype) for M in range(1, tk.MAX_DIM + 1)] == [1] * tk.MAX_DIM


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_splits_config4_within_the_cluster_limit(dtype):
    for M in range(1, tk.MAX_DIM + 1):
        S = tk.fused_plan(M, CONFIG4[1], dtype)
        assert 2 <= S <= tk.MAX_CLUSTER and S & (S - 1) == 0
    # The measured plan: the fewest blocks that give each of 256 threads one
    # column, 16 at most; monotone in n, and 1 below SPLIT_MIN_N.
    assert tk.fused_plan(8, CONFIG4[1], dtype) == 16
    plans = [tk.fused_plan(8, n, dtype) for n in (tk.SPLIT_MIN_N - 1, tk.SPLIT_MIN_N, 1024, 2048, 4096, 40960)]
    assert plans == [1, 2, 4, 8, 16, 16]


@pytest.mark.parametrize("m,n", [(8, 10240), (3, 5000), (3, 37)])
def test_wrappers_pass_a_plan_that_ignores_the_batch(monkeypatch, m, n):
    # The wrappers' CUDA branch with the launch replaced by a recorder: the
    # plan handed to the C entry point is fused_plan(m, n, dtype) for a
    # batch of 1 and of 130 alike, and is its last argument before the stream.
    seen = []
    monkeypatch.setattr(tk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tk, "_fused_args", lambda name, A, mask, *rest: 0)
    monkeypatch.setattr(tk, "_launch", lambda name, base, t, *args, plan=None: seen.append((name, t.shape[0], plan)))
    for B in (1, 130):
        A = torch.zeros(1, m, n).expand(B, m, n)
        fixed = torch.zeros(B, n, dtype=torch.bool)
        L = tk.masked_aat_cholesky(A, fixed)
        tk.project_tangent(A, L, fixed, torch.zeros(B, n))
    want = tk.fused_plan(m, n, torch.float32)
    assert seen == [(name, B, want) for B in (1, 130) for name in ("masked_aat_cholesky", "project_tangent")]


def test_entry_point_signatures_carry_the_plan():
    # masked_aat_cholesky: A, stride, fixed, reg, L, B, M, n, plan, stream;
    # project_tangent: A, stride, L, fixed, r, out, B, M, n, unmasked, plan, stream.
    I, P = ctypes.c_int, ctypes.c_void_p
    fac, proj = tk._SIGNATURES["benlsip_masked_aat_cholesky"], tk._SIGNATURES["benlsip_project_tangent"]
    assert len(fac) == 10 and fac[5:9] == [I] * 4 and fac[9] is P
    assert len(proj) == 12 and proj[6:11] == [I] * 5 and proj[11] is P


def test_cpu_calls_count_no_launch_by_plan():
    tk.reset_launches()
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.standard_normal((2, *CONFIG4)).astype(np.float32))
    fixed = torch.from_numpy(rng.random((2, CONFIG4[1])) < 0.3)
    L = tchol.factor_unfixed_aat(A, fixed, 1e-3)
    tchol.masked_projection(A, L, fixed, torch.from_numpy(rng.standard_normal((2, CONFIG4[1])).astype(np.float32)))
    assert set(tk.LAUNCHES) == {
        "batched_cholesky", "batched_cho_solve", "batched_thin_qr", "narrow_qr_r", "masked_aat_cholesky",
        "project_tangent", "blocked_qr_r", "polyhedron_newton", "minor_direction_r", "minor_loop_r",
    }
    assert sum(tk.LAUNCHES.values()) == 0 and not tk.LAUNCHES_BY_PLAN and not tk.LAUNCHES_BY_DTYPE
    tk.LAUNCHES_BY_PLAN["project_tangent", 16] += 1
    tk.reset_launches()
    assert not tk.LAUNCHES_BY_PLAN


# ---------------------------------------------------------------------------
# The plain versions at config 4's width against the JAX call sites
# ---------------------------------------------------------------------------


def wide_inputs(n, seed):
    """B = 2: lane 0 regular (the first 32 columns free, ~30% of the rest
    fixed), lane 1 degenerate (one free column under m equalities, entries
    of A in {±1, ±2}, so that its sums are exact in any order)."""
    rng = np.random.default_rng(seed)
    m, B = CONFIG4[0], 2
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    A[1] = rng.choice([-2.0, -1.0, 1.0, 2.0], (m, n))
    fixed = rng.random((B, n)) < 0.3
    fixed[:, :32] = False
    fixed[1] = True
    fixed[1, 1] = False
    r = rng.standard_normal((B, n)).astype(np.float32)
    return A, fixed, r


@pytest.mark.parametrize("n", [10240, 10277], ids=["n10240", "ragged_n10277"])
def test_wide_factor_plain_matches_jax(n):
    A, fixed, _ = wide_inputs(n, seed=n)
    L_t = tk.masked_aat_cholesky(torch.from_numpy(A), torch.from_numpy(fixed)).numpy()
    L_j = np.asarray(jax.vmap(lambda a, f: jchol.factor_masked_aat(a, f))(jnp.asarray(A), jnp.asarray(~fixed)))
    scale = np.abs(L_j[0]).max()
    assert np.isfinite(L_t[0]).all()
    np.testing.assert_allclose(L_t[0], L_j[0], rtol=1e-5, atol=1e-7 * np.sqrt(n) * scale)
    # The degenerate lane: NaN from its second column on, as the Pallas
    # kernel gives on the JAX masked product (XLA's Cholesky, the JAX call
    # site on the CPU, NaNs the lane's whole lower triangle).
    lower = np.tril_indices(CONFIG4[0])
    assert np.isnan(L_j[1][lower]).all() and np.isnan(L_t[1, 2, 1]) and not np.isnan(L_t[1, 0, 0])
    K = jax.vmap(jchol.masked_aat)(jnp.asarray(A), jnp.asarray(~fixed))
    L_pl = np.asarray(jk.batched_cholesky(K, interpret=True))
    np.testing.assert_array_equal(np.isnan(L_t), np.isnan(L_pl))


@pytest.mark.parametrize("n", [10240, 10277], ids=["n10240", "ragged_n10277"])
def test_wide_projection_plain_matches_jax(n):
    A, fixed, r = wide_inputs(n, seed=n + 1)
    L = tk.masked_aat_cholesky(torch.from_numpy(A), torch.from_numpy(fixed))
    P_t = tk.project_tangent(torch.from_numpy(A), L, torch.from_numpy(fixed), torch.from_numpy(r)).numpy()
    z = jnp.zeros((2, n), jnp.float32)
    poly = jc.Polyhedron(jnp.asarray(A), jnp.zeros((2, CONFIG4[0]), jnp.float32), z, z)
    P_j = np.asarray(jax.vmap(jpr.project_tangent)(poly, jc.ActiveSet(jnp.asarray(fixed), jnp.asarray(L.numpy())),
                                                  jnp.asarray(r)))
    np.testing.assert_allclose(P_t[0], P_j[0], rtol=1e-5, atol=1e-7 * np.sqrt(n) * np.abs(r).max())
    assert np.all(P_t[fixed] == 0)
    # A NaN factor gives a NaN row on the free entries, as in JAX.
    np.testing.assert_array_equal(np.isnan(P_t), np.isnan(P_j))
    assert np.isnan(P_t[1, 1]) and not np.isnan(P_t[1]).any(where=fixed[1])
