"""The port's whole-pipeline fusion (benlsip_tpu_torch.batch.fused_small and
the loop modes of benlsip_tpu_torch._loops) on the CPU, against the JAX
package's `solve_small_fused` and against the port's own unfused pipeline.

The graphs themselves run only on the card (chip_smoke.py); here the same
stages run as plain calls.  Tolerances:
- "all_trips" against "eager": bit-identical (every extra trip is masked
  away by `sel_tuple`, so no lane that is done moves), and no eager loop
  runs past the trip cap that bounds it in a graph (`CAP_OVERRUNS`);
- fused against unfused port, and the static-bucket certification (in
  either mode) against the eager pipeline's dynamic buckets: bit-identical
  (the same operations on the same lanes in the same order);
- the port against the JAX package: X to rtol 1e-6, atol 1e-8 (the JAX
  test's fused-vs-unfused bar, tests/test_polish.py), both certifying
  every lane at pix ≤ 1.5e-8.
"""
import numpy as np
import pytest
import torch

from benlsip_tpu.batch.fused_small import solve_small_fused as j_fused
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch import _loops
from benlsip_tpu_torch.batch import fused_small
from benlsip_tpu_torch.batch.fused_small import solve_small_fused
from benlsip_tpu_torch.batch.polish import FusedPolish, sqp_polish_fused
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import map_poly_fields, solve_batched
from benlsip_tpu_torch.interop import problem_from_numpy, theta_from_numpy
from benlsip_tpu_torch.kernels import batched_linalg as kern
from benlsip_tpu_torch.problems.generators import (
    _exp_fit_residuals, exp_fit_family, sphere_family,
)
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)


@pytest.fixture(scope="module")
def config2_pair():
    """exp_fit_family(32, d=32, seed=17) in both packages, chunk 16: the JAX
    package's fused result (computed once) and the port's problem data,
    handed over as numpy."""
    bp_j, th_j, X0_j = j_exp_fit(32, d=32, seed=17)
    Xj, Yj, ij = j_fused(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=16)
    bp = problem_from_numpy(np.asarray(bp_j.A), np.asarray(bp_j.b), np.asarray(bp_j.xl), np.asarray(bp_j.xu),
                            bp_j.poly_batched, _exp_fit_residuals, device="cpu")
    th = theta_from_numpy({k: np.asarray(v) for k, v in th_j.items()}, device="cpu")
    X0 = torch.as_tensor(np.array(X0_j))
    return (np.asarray(Xj), np.asarray(ij.converged), np.asarray(ij.pix)), (bp, th, X0)


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_same(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("family", ["exp_fit", "sphere"])
def test_all_trips_is_bit_identical_to_eager(family):
    # The f32 bulk at small caps (a dual Newton of up to 100 trips a
    # projection unrolls to every trip here): X, Y and every SolveInfo
    # field equal, so the extra masked trips move no lane that is done.
    if family == "exp_fit":
        bp, th, X0 = exp_fit_family(16, d=32, seed=4, dtype=torch.float32, device="cpu")
    else:
        bp, th, X0 = sphere_family(8, seed=4, dtype=torch.float32, device="cpu")
    opts = SolverOptions(max_outer_iter=3, max_inner_iter=4)
    out = {}
    overruns = _loops.CAP_OVERRUNS
    for mode in ("eager", "all_trips"):
        with _loops.loop_mode(mode):
            out[mode] = solve_batched(bp, th, X0, opts)
    _assert_same(out["eager"], out["all_trips"])
    assert _loops.CAP_OVERRUNS == overruns
    assert int(out["eager"][2].inner_iters.min()) >= 4   # the loops ran several trips


def test_fused_matches_jax(config2_pair):
    (Xj, okj, pixj), (bp, th, X0) = config2_pair
    X, Y, info = solve_small_fused(bp, th, X0, SolverOptions(**OPTS), chunk=16)
    assert okj.all() and bool(info.converged.all())
    assert float(info.pix.max()) <= 1.5e-8 and pixj.max() <= 1.5e-8
    assert X.dtype == torch.float64 and X.shape == (32, 3) and Y.shape == (32, 0)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-6, atol=1e-8)


def test_fused_matches_unfused_port(config2_pair, monkeypatch):
    _, (bp, th, X0) = config2_pair
    opts = SolverOptions(**OPTS)
    calls = []
    fused = fused_small.solve_small_fused
    monkeypatch.setattr(fused_small, "solve_small_fused", lambda *a, **k: calls.append(k) or fused(*a, **k))
    _loops.reset_host_syncs()
    overruns = _loops.CAP_OVERRUNS
    Xf, Yf, inf_f = solve_mixed_precision(bp, th, X0, opts, chunk=16, fuse=True)
    syncs = _loops.HOST_SYNCS
    assert len(calls) == 1 and calls[0]["bulk_max_inner"] == 8   # the fused route ran, with the bulk cap
    Xu, Yu, inf_u = solve_mixed_precision(bp, th, X0, opts, chunk=16)
    _assert_same((Xf, Yf, tuple(inf_f)), (Xu, Yu, tuple(inf_u)))
    assert syncs > 0
    # Every loop of both runs ended by its own predicate, inside the cap
    # its WHILE node has in a graph.
    assert _loops.CAP_OVERRUNS == overruns


def test_static_certification_matches_eager():
    # The straggler case of test_torch_certify.py: a cold start and a thin
    # step budget leave uncertified lanes, served in buckets of 4 by the
    # static passes of the fused pipeline (the graph's).  Eager mode stops
    # when no lane is owed a pass; "all_trips" runs all ⌈32/4⌉ of them,
    # masked; the eager pipeline cuts its buckets to the lanes owed a pass:
    # every output the same.
    B = 32
    bp, th, X0 = exp_fit_family(B, d=32, seed=13, device="cpu")
    bp32, th32 = _cast_problem(bp, torch.float32, "cpu"), _cast_tree(th, torch.float32)
    fp = FusedPolish(bp32, th32, bp, th, SolverOptions(**OPTS), 3, 1e-4, 0.0, 2, 2, 4)
    first = fp.first_round(X0.float())
    eager = fp.repolish(_loops.clone(first))
    with _loops.loop_mode("all_trips"):
        static = fp.repolish(_loops.clone(first))
    dynamic = sqp_polish_fused(bp32, th32, X0.float(), bp, th, SolverOptions(**OPTS), num_steps=3,
                               refactor_steps=2, rounds=2, straggler_bucket=4)
    assert int(eager.ok.sum()) > int(first.ok.sum())     # the passes certified stragglers
    _assert_same(eager, static)
    _assert_same(eager[:6], dynamic)


def test_fused_fallback_refines_the_uncertified_lanes(config2_pair):
    # A thin polish (3 steps, no re-polish) leaves lanes to the shared
    # full-f64 fallback, outside the stages; on the fallback device asked
    # for, with the same answer.
    _, (bp, th, X0) = config2_pair
    kw = dict(chunk=16, polish_steps=3, rounds=1)
    X, _, info = solve_small_fused(bp, th, X0, SolverOptions(**OPTS), **kw)
    Xh, _, info_h = solve_small_fused(bp, th, X0, SolverOptions(**OPTS), fallback_device="cpu", **kw)
    refined = info.outer_iters > 0
    assert 0 < int(refined.sum()) < 32 and bool(info.converged.all()) and float(info.pix.max()) <= 1.5e-8
    _assert_same((X, tuple(info)), (Xh, tuple(info_h)))


def test_fuse_without_polish_refines(config2_pair):
    # The JAX package fuses even with polish=False (benlsip_tpu/batch/refine.py:298);
    # the port refines every lane, as polish=False asks.
    _, (bp, th, X0) = config2_pair
    bp8, th8, X8 = map_poly_fields(bp, lambda a: a[:8]), {k: v[:8] for k, v in th.items()}, X0[:8]
    opts = SolverOptions(**OPTS)
    Xf, _, inf_f = solve_mixed_precision(bp8, th8, X8, opts, chunk=8, polish=False, fuse=True)
    Xu, _, inf_u = solve_mixed_precision(bp8, th8, X8, opts, chunk=8, polish=False)
    _assert_same((Xf, tuple(inf_f)), (Xu, tuple(inf_u)))
    assert int(inf_f.outer_iters.max()) > 0   # the full refine ran, not the polish


@pytest.mark.parametrize("kw", [{"fuse": True, "certify": "host"}, {"fuse": "auto"}, {"fuse": False}])
def test_plain_path_where_not_fused(monkeypatch, kw):
    # fuse=True with the host certification, and fuse="auto", take the plain path.
    def refuse(*a, **k):
        raise AssertionError("solve_small_fused must not run")

    monkeypatch.setattr(fused_small, "solve_small_fused", refuse)
    bp, th, X0 = exp_fit_family(4, d=16, seed=2, device="cpu")
    X, _, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), **kw)
    assert bool(info.converged.all()) and X.device.type == "cpu"


def test_capture_mode_on_cpu_raises():
    run = torch.ones(3, dtype=torch.bool)
    with _loops.loop_mode("capture"), pytest.raises(ValueError, match="CUDA"):
        _loops.masked_while(lambda c: c < 2, lambda c, act: c + 1, torch.zeros(3), run, 4)
    with pytest.raises(ValueError):
        with _loops.loop_mode("graph"):
            pass
    assert _loops._mode == "eager"


def test_replay_counts_without_graphs(config2_pair):
    # On the CPU the stages run as plain calls: nothing is captured, so the
    # replays ran nothing, and a reset leaves it so.
    _, (bp, th, X0) = config2_pair
    first = lambda a: a[:4]
    solve_small_fused(map_poly_fields(bp, first), {k: first(v) for k, v in th.items()}, first(X0), SolverOptions(**OPTS),
                      chunk=4)
    fused_small.reset_replay_counts()
    counts = fused_small.replay_counts()
    assert counts["replays"] == counts["loop_trips"] == counts["device_kernels"] == counts["device_copies"] == 0
    assert set(counts["launches"]) == set(kern.LAUNCHES) and not any(counts["launches"].values())


def test_unported_fallback_pad_raises(config2_pair):
    # The JAX fallback pads its bucket to a power of two up to fallback_pad;
    # eager PyTorch pads nothing, so only the default is accepted, and any
    # other value is refused as a deliberate difference.
    _, (bp, th, X0) = config2_pair
    with pytest.raises(ValueError, match="fallback_pad"):
        solve_small_fused(bp, th, X0, SolverOptions(**OPTS), fallback_pad=4)
