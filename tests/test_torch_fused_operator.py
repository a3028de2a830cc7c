"""`fuse=True` on a bulk that materializes the Gauss-Newton operator
(benlsip_tpu_torch.batch.fused_small on config 3's route: n ≥ 64 and
d ≥ 2n, the CholeskyQR2 operator) on the CPU, against the JAX package's
`solve_small_fused`, the port's unfused pipeline and itself in the
"all_trips" loop mode; and the two CholeskyQR2 rescues of `ops/qr` without
host decisions ("all_trips", what a CUDA graph computes) against eager.

The graphs themselves run only on the card (chip_smoke.py phase 5); here
the same stages run as plain calls.  Tolerances:
- "all_trips" against "eager": bit-identical (every extra trip and every
  branch run unconditionally is masked away per lane), and no eager loop
  runs past the trip cap that bounds it in a graph (`CAP_OVERRUNS`);
- fused against unfused port: the bulk's X bit-identical (the same
  stages on the same lanes), the certified X to rtol 1e-6 / atol 1e-8 (the
  unfused port certifies n ≥ 64 through `sqp_polish_split`, the fused route
  through `FusedPolish`, as the JAX program does), both certifying every
  lane;
- the port against the JAX package: X to rtol 1e-6, atol 1e-8 (the JAX
  test's fused-vs-unfused bar, tests/test_polish.py), both certifying
  every lane at pix ≤ 1.5e-8;
- a rescued lane: RᵀR against SᵀS to 1e-5 relative (Frobenius) in both
  modes, the healthy lanes bit-identical.
"""
import numpy as np
import pytest
import torch

from benlsip_tpu.batch.fused_small import solve_small_fused as j_fused
from benlsip_tpu.problems import generators as jgen
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch import _loops
from benlsip_tpu_torch.batch import fused_small
from benlsip_tpu_torch.batch import polish as tpolish
from benlsip_tpu_torch.batch.fused_small import solve_small_fused
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.ops import qr as tqr
from benlsip_tpu_torch.problems import generators as tgen
from benlsip_tpu_torch.solver import subproblem
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=30, max_inner_iter=100)
FAMILY = dict(n=64, d=128, m=2, seed=0)    # d = 2n: the materialized CholeskyQR2 route
B = 4


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_same(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def config3_jax():
    """The JAX package's fused result on the family (computed once: its
    compile dominates this file's time)."""
    bp, th, X0 = jgen.dense_quadratic_family(B, **FAMILY)
    X, _, info = j_fused(bp, th, X0, JOptions(**OPTS), chunk=B)
    return np.asarray(X), np.asarray(info.converged), np.asarray(info.pix)


def test_family_takes_the_materialized_route():
    bp, th, X0 = tgen.dense_quadratic_family(B, **FAMILY, device="cpu")
    opts = SolverOptions(**OPTS)
    fns = bp.instance_fns(th)
    d_plus_p = fns.residuals(X0).shape[-1] + fns.nlconstraints(X0).shape[-1]
    assert subproblem.resolve_operator_route(opts, FAMILY["n"], d_plus_p, torch.float32) == (True, "cholqr2")


def test_fused_operator_matches_jax(config3_jax):
    Xj, okj, pixj = config3_jax
    bp, th, X0 = tgen.dense_quadratic_family(B, **FAMILY, device="cpu")
    subproblem.reset_operator_builds()
    X, Y, info = solve_small_fused(bp, th, X0, SolverOptions(**OPTS), chunk=B)
    assert set(subproblem.OPERATOR_BUILDS) == {("cholqr2", "float32")}   # the bulk built the operator
    assert okj.all() and bool(info.converged.all())
    assert float(info.pix.max()) <= 1.5e-8 and pixj.max() <= 1.5e-8
    assert X.dtype == torch.float64 and X.shape == (B, FAMILY["n"])
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-6, atol=1e-8)


def test_fused_operator_matches_unfused_port(monkeypatch):
    bp, th, X0 = tgen.dense_quadratic_family(B, **FAMILY, device="cpu")
    opts = SolverOptions(**OPTS)
    bulk_x = []
    polish_then_refine = tpolish.polish_then_refine
    monkeypatch.setattr(tpolish, "polish_then_refine",
                        lambda bp_, th_, X32, *a, **k: bulk_x.append(X32.clone()) or polish_then_refine(bp_, th_, X32, *a, **k))
    overruns = _loops.CAP_OVERRUNS
    Xf, _, inf_f = solve_mixed_precision(bp, th, X0, opts, chunk=B, fuse=True)
    pipe = next(reversed(fused_small._PIPELINES.values()))
    Xu, _, inf_u = solve_mixed_precision(bp, th, X0, opts, chunk=B)
    assert len(bulk_x) == 1                    # the unfused route's certification ran once, the fused one not
    assert torch.equal(pipe.X32, bulk_x[0])    # the same bulk, bit for bit
    assert bool(inf_f.converged.all()) and bool(inf_u.converged.all())
    assert float(inf_f.pix.max()) <= 1.5e-8 and float(inf_u.pix.max()) <= 1.5e-8
    np.testing.assert_allclose(Xf.numpy(), Xu.numpy(), rtol=1e-6, atol=1e-8)
    assert _loops.CAP_OVERRUNS == overruns


def test_fused_operator_all_trips_is_bit_identical_to_eager():
    # Small caps (every loop runs to its cap in "all_trips"): the bulk's
    # operator rebuilds and both rescues run unconditionally and are
    # selected per lane, and nothing that is done moves.
    bp, th, X0 = tgen.dense_quadratic_family(B, **FAMILY, device="cpu")
    opts = SolverOptions(max_outer_iter=2, max_inner_iter=3, max_minor_iter=2, cauchy_max_trials=4)
    out, builds = {}, {}
    overruns = _loops.CAP_OVERRUNS
    for mode in ("eager", "all_trips"):
        subproblem.reset_operator_builds()
        with _loops.loop_mode(mode):
            X, Y, info = solve_small_fused(bp, th, X0, opts, chunk=B)
        out[mode], builds[mode] = (X, Y, tuple(info)), subproblem.OPERATOR_BUILDS[("cholqr2", "float32")]
    _assert_same(out["eager"], out["all_trips"])
    assert _loops.CAP_OVERRUNS == overruns
    # "all_trips" rebuilds on every trip, eager only where a lane accepted.
    assert 0 < builds["eager"] < builds["all_trips"]


def _conditioned(rng, d, n, kappa):
    U = np.linalg.qr(rng.standard_normal((d, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (U * np.logspace(0, -np.log10(kappa), n)) @ V.T


def _stack(seed=21, lanes=3, d=256, n=64):
    rng = np.random.default_rng(seed)
    return np.stack([_conditioned(rng, d, n, 1e2) for _ in range(lanes)])


def _gram_error(R, S):
    R, S = R.double().numpy(), S.double().numpy()
    G = np.swapaxes(S, 1, 2) @ S
    return np.linalg.norm(np.swapaxes(R, 1, 2) @ R - G, axis=(1, 2)) / np.linalg.norm(G, axis=(1, 2))


def test_shift_rescue_all_trips_matches_eager(monkeypatch):
    # Lane 1's first Cholesky of G is forced to break down: the shifted
    # factor G + σI takes its place as R₁, and the implicit refinement
    # corrects the product.  Eager asks the host and shifts when a lane
    # needs it; "all_trips" shifts every lane and selects lane 1.
    S = torch.from_numpy(_stack()).float()
    chol_upper = tqr._chol_upper
    calls = []

    def first_breaks_lane_1(G):
        R = chol_upper(G)
        calls.append(G.shape[0])
        if len(calls) == 1:
            R = R.clone()
            R[1] = float("nan")
        return R

    monkeypatch.setattr(tqr, "_chol_upper", first_breaks_lane_1)
    out = {}
    for mode in ("eager", "all_trips"):
        calls.clear()
        with _loops.loop_mode(mode):
            out[mode] = tqr.cholqr2i_r(S)
        # The unshifted factor, the shifted one (for the whole batch in
        # both modes), the refinement: one more in "all_trips", whose
        # refinement factor also has its shifted twin computed.
        assert calls[:2] == [3, 3]
    eager, at = out["eager"], out["all_trips"]
    assert torch.equal(eager, at)
    err = _gram_error(eager, S)
    assert err.max() <= 1e-5, err
    # Lane 1 really took the shifted R₁: without the forced breakdown it differs.
    monkeypatch.setattr(tqr, "_chol_upper", chol_upper)
    plain = tqr.cholqr2i_r(S)
    assert torch.equal(plain[[0, 2]], eager[[0, 2]]) and not torch.equal(plain[1], eager[1])


def test_explicit_rescue_all_trips_matches_eager(monkeypatch):
    # Lane 0's implicit refinement is forced to break down (flagged bad,
    # R₂ = I): the explicit pass on S rescues it.  Eager gathers lane 0
    # and runs the pass on it alone; "all_trips" runs it on every lane
    # behind `branch_any` and selects lane 0.  Healthy lanes keep their
    # implicit R₂ bit for bit; the rescued lane meets the RᵀR bar in both.
    S = torch.from_numpy(_stack(seed=22)).float()
    implicit = tqr._implicit_refine_r2

    def lane_0_broken(G, R1):
        R2, bad = implicit(G, R1)
        bad = bad.clone()
        bad[0] = True
        R2 = torch.where(bad, torch.eye(G.shape[-1]), R2)
        return R2, bad

    monkeypatch.setattr(tqr, "_implicit_refine_r2", lane_0_broken)
    seen = []
    explicit = tqr._explicit_r2
    monkeypatch.setattr(tqr, "_explicit_r2", lambda S_, R1: seen.append(S_.shape[0]) or explicit(S_, R1))
    out = {}
    for mode in ("eager", "all_trips"):
        with _loops.loop_mode(mode):
            out[mode] = tqr.cholqr2i_r(S)
    assert seen == [1, 3]
    eager, at = out["eager"], out["all_trips"]
    assert torch.equal(eager[1:], at[1:])
    for R in (eager, at):
        err = _gram_error(R, S)
        assert err.max() <= 1e-5, err
    # The rescued lane, the pass over three lanes against the gathered pass
    # over one: the batched library calls may sum in another order by batch
    # size (`ops/qr.rescue_broken_refinement`).  On the CPU the bits agree
    # at this size but not at config 3's (8x1030x192: 1.8e-7); hold it to
    # a few float32 ulps of R.
    np.testing.assert_allclose(at[0].numpy(), eager[0].numpy(), rtol=0, atol=1e-6 * float(eager[0].abs().max()))


def test_if_any_modes_on_cpu():
    # Eager asks the host (one counted sync a branch); "all_trips" runs the
    # body unconditionally and syncs nothing; capture needs CUDA tensors.
    mask = torch.tensor([False, True, False])
    none = torch.zeros(3, dtype=torch.bool)
    _loops.reset_host_syncs()
    with _loops.if_any(mask) as taken, _loops.if_any(none) as not_taken:
        assert taken and not not_taken
    assert _loops.HOST_SYNCS == 2
    with _loops.loop_mode("all_trips"), _loops.if_any(none) as taken:
        assert taken
    assert _loops.HOST_SYNCS == 2
    with _loops.loop_mode("capture"), pytest.raises(ValueError, match="CUDA"):
        with _loops.if_any(mask):
            pass


def test_branch_any_selects_like_eager():
    # branch_any returns `otherwise` when no lane takes the branch in eager
    # mode, the branch's per-lane selection otherwise, and in "all_trips"
    # the branch's result either way: equal, since the branch selects.
    x = torch.arange(3.0)
    for mask in (torch.tensor([False, True, False]), torch.zeros(3, dtype=torch.bool)):
        branch = lambda: torch.where(mask, -x, x)
        eager = _loops.branch_any(mask, branch, x)
        with _loops.loop_mode("all_trips"):
            at = _loops.branch_any(mask, branch, x)
        assert torch.equal(eager, at) and torch.equal(eager, torch.where(mask, -x, x))
    # The carries of `branch_any` may be plain tuples of tensors and
    # NamedTuples (the TR loop's (g, H)).
    pair = (x, (x, None))
    copy = _loops.clone(pair)
    assert type(copy) is tuple and copy[1][1] is None and torch.equal(copy[0], x) and copy[0] is not x
    before = dict(_loops.NOTED)
    _loops.note(("operator_build", "cholqr2", "float32"))     # outside a capture: nothing
    assert dict(_loops.NOTED) == before
