"""Converged-instance compaction of the port (batch/compact.py) against the
port's chunked solve and against the JAX package's `solve_batched_compact`.

Cutting the outer loop at a horizon leaves every lane's trajectory as it
was, and on the CPU no op of the bulk depends on the batch it runs in, so
the compacted solve equals the chunked one bit for bit (the JAX package's
own test asserts the same of its module).  Against JAX, in float32: X
within 1e-5, statuses and outer counts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch.compact import solve_batched_compact as j_compact
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch import compact
from benlsip_tpu_torch.batch.compact import solve_batched_compact
from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
from benlsip_tpu_torch.interop import info_to_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=24)


def _equal(a, b):
    X, Y, info = a
    Xk, Yk, ik = b
    assert torch.equal(X, Xk) and torch.equal(Y, Yk)
    for f, t, tk in zip(info._fields, info, ik):
        assert t.dtype == tk.dtype and torch.equal(t, tk), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_compact_bitwise_parity_with_chunked(dtype):
    # One chunk, a horizon low enough that stage B has survivors in
    # buckets of 16.
    bp, th, X0 = exp_fit_family(64, d=32, seed=3, dtype=dtype, device="cpu")
    opts = SolverOptions(**OPTS)
    ref = solve_batched_chunked(bp, th, X0, opts, chunk=64)
    compact.reset_stats()
    out = solve_batched_compact(bp, th, X0, opts, chunk=64, stage_outer=3, survivor_chunk=16)
    _equal(ref, out)
    (stats,) = compact.STATS
    assert stats["lanes"] == 64 and 0 < stats["survivors"] < 64
    assert stats["survivors"] == int((ref[2].outer_iters > 3).sum())


def test_compact_parity_across_chunk_boundaries():
    # Two chunks of 24 and a ragged tail of 8 in stage A, several survivor
    # buckets of 4 in stage B.
    bp, th, X0 = exp_fit_family(56, d=32, seed=9, dtype=torch.float32, device="cpu")
    opts = SolverOptions(**OPTS)
    ref = solve_batched_chunked(bp, th, X0, opts, chunk=24)
    compact.reset_stats()
    out = solve_batched_compact(bp, th, X0, opts, chunk=24, stage_outer=2, survivor_chunk=4)
    _equal(ref, out)
    (stats,) = compact.STATS
    assert stats["buckets"] >= 2 and stats["buckets"] == -(-stats["survivors"] // 4)


def test_compact_no_survivors_short_circuits():
    # A horizon past every lane's schedule leaves stage B empty.
    bp, th, X0 = exp_fit_family(16, d=32, seed=5, dtype=torch.float32, device="cpu")
    opts = SolverOptions(**OPTS)
    ref = solve_batched_chunked(bp, th, X0, opts, chunk=16)
    compact.reset_stats()
    out = solve_batched_compact(bp, th, X0, opts, chunk=16, stage_outer=60)
    _equal(ref, out)
    assert compact.STATS == [{"lanes": 16, "survivors": 0, "buckets": 0}]


def test_compact_matches_jax():
    bp_j, th_j, X0_j = j_exp_fit(48, d=32, seed=3, dtype=jnp.float32)
    Xj, _, ij = j_compact(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=32, stage_outer=2, survivor_chunk=8)
    bp, th, X0 = exp_fit_family(48, d=32, seed=3, dtype=torch.float32, device="cpu")
    Xt, Yt, it = solve_batched_compact(bp, th, X0, SolverOptions(**OPTS), chunk=32, stage_outer=2, survivor_chunk=8)
    info = info_to_numpy(it)
    assert Xt.dtype == torch.float32 and Yt.shape == (48, 0)
    np.testing.assert_array_equal(info["status"], np.asarray(ij.status))
    np.testing.assert_array_equal(info["outer_iters"], np.asarray(ij.outer_iters))
    assert info["converged"].all()
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-5)
