"""The fused pipeline's certification in static shapes
(benlsip_tpu_torch.batch.polish.FusedPolish.repolish, what
batch/fused_small captures) against the JAX package's static re-polish
pass (benlsip_tpu/batch/polish.py `_fused_polish_core`: `lax.top_k`
buckets in a `lax.while_loop`), on the CPU.

The straggler fixture of tests/test_polish.py and test_torch_certify.py:
exp_fit_family(32, d=32, seed=13) polished from its cold start with a thin
step budget (3 steps, 2 of them refactoring), buckets of 4, so the first
round leaves most lanes uncertified and the passes serve them.  With B=32
and a bucket of 4 the port's pass cap ⌈B / bucket⌉·(rounds − 1) equals the
JAX cap 8·(rounds − 1).  The problem data reach both packages as numpy.
Tolerances: the same lanes certified, and X within rtol 1e-7 / atol 1e-9
on them (test_torch_certify.py's polish bar: only the f32 factors' rounding
differs, MGS here and Householder in XLA); the static passes equal the
eager pipeline's dynamic ones bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch.polish import sqp_polish_fused as j_polish
from benlsip_tpu.batch.refine import _cast_tree as j_cast
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch import _loops
from benlsip_tpu_torch.batch.polish import FusedPolish, sqp_polish_fused
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
from benlsip_tpu_torch.interop import problem_from_numpy, theta_from_numpy
from benlsip_tpu_torch.problems.generators import _exp_fit_residuals
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)
B, BUCKET = 32, 4
KW = dict(num_steps=3, refactor_steps=2, straggler_bucket=BUCKET)


@pytest.fixture(scope="module")
def stragglers():
    """The JAX problem in f64 and f32, and the port's, from the same numpy data."""
    bp_j, th_j, X0_j = j_exp_fit(B, d=32, seed=13)
    bp32_j = dataclasses.replace(bp_j, **{f: getattr(bp_j, f).astype(jnp.float32) for f in ("A", "b", "xl", "xu")})
    bp = problem_from_numpy(np.asarray(bp_j.A), np.asarray(bp_j.b), np.asarray(bp_j.xl), np.asarray(bp_j.xu),
                            bp_j.poly_batched, _exp_fit_residuals, device="cpu")
    th = theta_from_numpy({k: np.asarray(v) for k, v in th_j.items()}, device="cpu")
    return (bp_j, th_j, bp32_j, j_cast(th_j, jnp.float32), X0_j.astype(jnp.float32)), (bp, th, X0_j)


@pytest.mark.parametrize("rounds", [2, 4])
def test_static_repolish_matches_jax(stragglers, rounds):
    (bp_j, th_j, bp32_j, th32_j, X32_j), (bp, th, X0_np) = stragglers
    Xj, _, okj, pixj, *_ = j_polish(bp32_j, th32_j, X32_j, bp_j, th_j, JOptions(**OPTS), rounds=rounds, **KW)

    bp32, th32 = _cast_problem(bp, torch.float32, "cpu"), _cast_tree(th, torch.float32)
    X32 = torch.from_numpy(np.array(X32_j))
    fp = FusedPolish(bp32, th32, bp, th, SolverOptions(**OPTS), KW["num_steps"], 1e-4, 0.0, KW["refactor_steps"],
                     rounds, BUCKET)
    first = fp.first_round(X32)
    n_first = int(first.ok.sum())
    s = fp.repolish(_loops.clone(first))

    # The passes served the stragglers: more than one bucket of them, each
    # lane owed a pass had all rounds - 1 of them or was certified.
    assert n_first <= B - 2 * BUCKET and int(s.ok.sum()) > n_first
    assert bool(((s.att == rounds - 1) | s.ok).all()) and int(s.att.sum()) > BUCKET
    okj = np.asarray(okj)
    np.testing.assert_array_equal(s.ok.numpy(), okj)
    np.testing.assert_allclose(s.x.numpy()[okj], np.asarray(Xj)[okj], rtol=1e-7, atol=1e-9)
    assert float(s.pix[s.ok].max()) <= 1.5e-8 and float(np.asarray(pixj)[okj].max()) <= 1.5e-8

    # The eager pipeline's dynamic buckets serve the same lanes in the same order.
    dyn = sqp_polish_fused(bp32, th32, X32, bp, th, SolverOptions(**OPTS), rounds=rounds, **KW)
    for got, want in zip(s[:6], dyn):
        assert torch.equal(got, want)
