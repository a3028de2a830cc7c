"""Padding and difficulty bucketing of the port (batch/buckets.py) against
the JAX package's `batch/buckets.py`: each helper gives JAX's numbers on
the same inputs, a padded residual solves as the unpadded one, a reorder
round-trips, and the difficulty-sorted solve gives the port's chunked
results bit for bit (per-lane results do not depend on the chunk a lane
runs in) and JAX's sorted results in float64 within 1e-7, the bulk
tests' bar."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch import buckets as j_buckets
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch import buckets
from benlsip_tpu_torch.batch.vmap_solve import solve_batched, solve_batched_chunked
from benlsip_tpu_torch.interop import info_to_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)
SIZES = {
    "mixed": [3, 17, 9, 33, 12, 12, 64, 5],
    "outlier": [8] * 1000 + [4096],
    "equal": [7] * 50,
    "dense": list(range(1, 100)),
}


@pytest.mark.parametrize("max_buckets", [1, 3, 4])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_bucket_edges_and_assignment_match_jax(kind, max_buckets):
    sizes = SIZES[kind]
    edges = buckets.bucket_edges(sizes, max_buckets=max_buckets)
    assert edges == j_buckets.bucket_edges(sizes, max_buckets=max_buckets)
    groups = buckets.assign_buckets(sizes, edges)
    for g, gj in zip(groups, j_buckets.assign_buckets(sizes, edges), strict=True):
        np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(np.sort(np.concatenate(groups)), np.arange(len(sizes)))


def test_difficulty_order_reorder_roundtrip():
    iters = np.array([50, 3, 20, 7, 3, 20], np.int32)
    order = buckets.difficulty_order(torch.as_tensor(iters))
    np.testing.assert_array_equal(order, j_buckets.difficulty_order(jnp.asarray(iters)))
    np.testing.assert_array_equal(buckets.inverse_order(order), j_buckets.inverse_order(order))
    tree = {"a": torch.arange(6.0), "b": torch.arange(12.0).reshape(6, 2)}
    fwd = buckets.reorder(tree, order)
    want = j_buckets.reorder({k: jnp.asarray(v.numpy()) for k, v in tree.items()}, order)
    for k in tree:
        np.testing.assert_array_equal(fwd[k].numpy(), np.asarray(want[k]))
    back = buckets.reorder(fwd, buckets.inverse_order(order))
    for k in tree:
        assert torch.equal(back[k], tree[k])


def test_padded_residuals_solve_identically():
    bp, th, X0 = exp_fit_family(8, d=12, seed=7, device="cpu")
    opts = SolverOptions(**OPTS)
    X_ref, _, i_ref = solve_batched(bp, th, X0, opts)
    bp_pad = dataclasses.replace(bp, residuals=buckets.pad_residuals(bp.residuals, 12 + 9))
    assert bp_pad.instance_fns(th).residuals(X0).shape == (8, 21)
    X_pad, _, i_pad = solve_batched(bp_pad, th, X0, opts)
    torch.testing.assert_close(X_pad, X_ref, rtol=1e-9, atol=1e-11)
    assert torch.equal(i_pad.converged, i_ref.converged) and bool(i_ref.converged.all())


def test_sorted_solve_matches_chunked():
    opts = SolverOptions(**dict(OPTS, max_inner_iter=24))
    bp, th, X0 = exp_fit_family(40, d=32, seed=9, dtype=torch.float32, device="cpu")
    X, Y, info = buckets.solve_batched_sorted(bp, th, X0, opts, chunk=8)
    Xc, Yc, ic = solve_batched_chunked(bp, th, X0, opts, chunk=8)
    assert torch.equal(X, Xc) and torch.equal(Y, Yc)
    for t, tc in zip(info, ic):
        assert torch.equal(t, tc)


def test_sorted_solve_matches_jax():
    # float64: in float32 a lane at the f32 criticality floor stalls in one
    # package and converges in the other (rounding), sorted or not.
    bp, th, X0 = exp_fit_family(40, d=32, seed=9, device="cpu")
    X, _, info = buckets.solve_batched_sorted(bp, th, X0, SolverOptions(**OPTS), chunk=8)
    bp_j, th_j, X0_j = j_exp_fit(40, d=32, seed=9)
    Xj, _, ij = j_buckets.solve_batched_sorted(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=8)
    got = info_to_numpy(info)
    np.testing.assert_array_equal(got["status"], np.asarray(ij.status))
    assert got["converged"].all()
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)
