"""The bf16 bulk of the port's `solve_mixed_precision` and the ops it runs,
against the JAX package's bf16 pipeline, and the TF32 knobs
(`SolverOptions.matmul_precision`, `bulk_matmul_precision`).

* The ops follow the JAX package's bf16 rules: `gram_j` accumulates in
  float32, CholeskyQR2 computes in float32 and returns bf16, the library
  QR round-trips through float32, and the dual Newton of the polyhedral
  projection keeps the f64 line-search geometry for bf16.  Tolerances are
  bf16 grade (see each test).
* `exp_fit_family(32, d=32, seed=21)` with `bulk_dtype=torch.bfloat16`:
  every lane certified at pix ≤ 1.49e-8 and X within rtol 1e-7 / atol 1e-8
  (the JAX package's own bar, tests/test_refine.py) of the JAX package's
  bf16 pipeline and of the port's float32-bulk run; compaction gives the
  plain bf16 route's bits, and the sorted bulk, the host certification and
  polish=False certify every lane.
* TF32 is a process flag: `solve_fixed_point` sets it from
  `matmul_precision` for its iteration and restores it, also after an
  exception; the certification runs with it off; on the CPU, which has no
  TF32, X is bitwise the "highest" run's.
* The routes that would drop a bf16 bulk or a matmul precision refuse it.
The families with a nonlinear constraint and with a materialized operator
are in tests/test_torch_bf16_families.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch import refine as j_refine
from benlsip_tpu.ops import al as jal
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import polyproject as jpp
from benlsip_tpu.ops import qr as jqr
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch import compact, polish
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import map_poly_fields
from benlsip_tpu_torch.ops import al as tal
from benlsip_tpu_torch.ops import polyproject as tpp
from benlsip_tpu_torch.ops import qr as tqr
from benlsip_tpu_torch.ops.constraints import Polyhedron
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver import outer, subproblem
from benlsip_tpu_torch.solver.api import NLSFunctions
from benlsip_tpu_torch.solver.options import MATMUL_PRECISIONS, SolverOptions

torch.set_num_threads(2)
rng = np.random.default_rng(12)
BF = torch.bfloat16
EPS32 = float(np.finfo(np.float32).eps)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)
B, SEED = 32, 21
CERT = 1.49e-8


def bf16(a) -> np.ndarray:
    """a rounded once to bf16, held as float32 (what both packages get)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def t_bf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def j_bf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def assert_bf16_grade(got, want, M):
    """|Δ| ≤ 2·M·2⁻⁸·max|out| in every instance (axis 0)."""
    got, want = f32(got), f32(want)
    Bn = got.shape[0]
    err = np.abs(got - want).reshape(Bn, -1).max(1)
    assert np.all(err <= 2 * M * 2.0 ** -8 * np.abs(want).reshape(Bn, -1).max(1))


def assert_within_one_ulp(got, want, f32_scale=0.0):
    """One bf16 ulp of each entry, plus float32 rounding of the two
    float32 computations behind the two roundings."""
    got, want = f32(got), f32(want)
    x = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    slack = 2.0 ** (np.floor(np.log2(x)) - 7) + 8 * EPS32 * f32_scale
    assert np.all(np.abs(got - want) <= slack), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# The ops around the kernels: the JAX package's bf16 rules
# ---------------------------------------------------------------------------


def test_gram_j_bf16_accumulates_in_float32():
    J = bf16(rng.standard_normal((3, 48, 10)))
    G_t = tal.gram_j(t_bf(J))
    G_j = jax.vmap(jal.gram_j)(j_bf(J))
    assert G_t.dtype == torch.float32 and G_j.dtype == jnp.float32
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(G_j)).max())
    # The Gram operator itself stays in the operator's dtype, as in JAX.
    H = tal.with_gram(tal.AlHessian(t_bf(J), torch.zeros((3, 0, 10), dtype=BF), torch.ones(3, dtype=BF)))
    assert H.G.dtype == BF


def test_cholqr2_operator_bf16_matches_jax():
    J = bf16(rng.standard_normal((3, 80, 12)))
    C = bf16(rng.standard_normal((3, 2, 12)))
    mu = bf16(np.array([10.0, 100.0, 1000.0]))
    H_t = tal.with_r_factor_cholqr2(tal.AlHessian(t_bf(J), t_bf(C), t_bf(mu)))
    H_j = jax.vmap(lambda a, c, u: jal.with_r_factor_cholqr2(jal.AlHessian(a, c, u)))(j_bf(J), j_bf(C), j_bf(mu))
    assert H_t.R.dtype == BF and H_j.R.dtype == jnp.bfloat16
    # Both compute in float32 (LAPACK against XLA's Cholesky) and round once.
    assert_within_one_ulp(H_t.R, H_j.R, np.abs(f32(H_j.R)).max())
    # RᵀR against the float64 SᵀS at bf16 grade.
    S = np.concatenate([J, np.sqrt(mu)[:, None, None] * C], axis=1).astype(np.float64)
    G = np.einsum("bdi,bdj->bij", S, S)
    R = f32(H_t.R).astype(np.float64)
    assert np.linalg.norm(np.einsum("bki,bkj->bij", R, R) - G) / np.linalg.norm(G) < 0.05


def test_cholqr2i_r_bf16_roundtrip():
    # The counterpart of tests/test_cholqr2.py's bf16 round trip, batched.
    S = bf16(rng.standard_normal((3, 128, 8)))
    R = tqr.cholqr2i_r(t_bf(S))
    assert R.dtype == BF
    G = np.einsum("bdi,bdj->bij", S.astype(np.float64), S.astype(np.float64))
    R64 = f32(R).astype(np.float64)
    assert np.linalg.norm(np.einsum("bki,bkj->bij", R64, R64) - G) / np.linalg.norm(G) < 0.05
    R_j = jax.vmap(jqr.cholqr2i_r)(j_bf(S))
    assert R_j.dtype == jnp.bfloat16
    assert_within_one_ulp(R, R_j, np.abs(f32(R_j)).max())


def test_qr_bf16_batched_routes():
    # The counterpart of tests/test_qr_path.py's bf16 fallback test: the
    # narrow gate (the kernel's plain version) and the wide float32 route.
    S = bf16(rng.standard_normal((4, 16, 3)))
    R = tqr.qr_r(t_bf(S))
    Q, R2 = tqr.thin_qr(t_bf(S))
    assert R.dtype == Q.dtype == R2.dtype == BF
    StS = np.einsum("bdi,bdj->bij", S, S)
    RtR = np.einsum("bki,bkj->bij", f32(R), f32(R))
    np.testing.assert_allclose(RtR, StS, rtol=0.1, atol=0.1)
    R_j = f32(jax.vmap(jqr.qr_r)(j_bf(S)))
    sign = np.sign(np.diagonal(R_j, axis1=1, axis2=2))
    assert_bf16_grade(R, R_j * sign[:, :, None], 3)
    S2 = t_bf(rng.standard_normal((2, 64, 32)))
    assert tqr.qr_r(S2).shape == (2, 32, 32) and tqr.qr_r(S2).dtype == BF
    Q2, R3 = tqr.thin_qr(S2)
    assert Q2.dtype == R3.dtype == BF and Q2.shape == (2, 64, 32)


def test_polyproject_bf16_lane_matches_jax():
    # The line search keeps the JAX module's geometry: float32 alone gets
    # (40, 6); bf16 takes float64's (60, 14).
    assert tpp.line_search_geometry(torch.float32) == (40, 6)
    assert tpp.line_search_geometry(BF) == tpp.line_search_geometry(torch.float64) == (60, 14)
    Bp, m, n = 6, 2, 7
    A = bf16(rng.standard_normal((Bp, m, n)))
    x0 = bf16(rng.uniform(-0.5, 0.5, (Bp, n)))
    b = bf16(np.einsum("bmn,bn->bm", A, x0))
    xl, xu = bf16(np.full((Bp, n), -0.6)), bf16(np.full((Bp, n), 0.6))
    x = bf16(rng.standard_normal((Bp, n)))
    poly = Polyhedron(t_bf(A), t_bf(b), t_bf(xl), t_bf(xu))
    v_t = tpp.projection_polyhedron(poly, t_bf(x))
    j_poly = jc.Polyhedron(j_bf(A), j_bf(b), j_bf(xl), j_bf(xu))
    v_j = jax.vmap(jpp.projection_polyhedron)(j_poly, j_bf(x))
    assert v_t.dtype == BF and v_j.dtype == jnp.bfloat16
    assert np.all(f32(v_t) >= xl) and np.all(f32(v_t) <= xu)
    # Both reach the projection to bf16 grade (the Newton iterations round
    # at other places): the residual of Av = b at its tolerance eps^0.75
    # relative, and the two points within a few bf16 ulps of the box.
    eps = 2.0 ** -7
    res = np.abs(np.einsum("bmn,bn->bm", A, f32(v_t)) - b).max(1)
    assert np.all(res <= 8 * eps * (1 + np.abs(b).max(1)) * np.abs(A).max()), res
    np.testing.assert_allclose(f32(v_t), f32(v_j), rtol=0, atol=8 * eps)


# ---------------------------------------------------------------------------
# The bf16 pipeline on config 2's family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def family():
    return exp_fit_family(B, d=32, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def runs(family):
    bp, th, X0 = family
    opts = SolverOptions(**OPTS)
    subproblem.reset_operator_builds()
    out = {"bf16": solve_mixed_precision(bp, th, X0, opts, chunk=B, bulk_dtype=BF)}
    out["builds"] = dict(subproblem.OPERATOR_BUILDS)
    out["f32"] = solve_mixed_precision(bp, th, X0, opts, chunk=B)
    return out


def _first(family, k):
    """The first k instances of the family."""
    bp, th, X0 = family
    return map_poly_fields(bp, lambda a: a[:k]), {n: v[:k] for n, v in th.items()}, X0[:k]


def _certified(info):
    assert bool(info.converged.all()) and float(info.pix.max()) <= CERT


def test_bf16_bulk_matches_jax_and_float32_bulk(runs):
    X, Y, info = runs["bf16"]
    _certified(info)
    assert X.dtype == torch.float64 and X.shape == (B, 3)
    assert runs["builds"] == {}      # n = 3: the matrix-free operator
    bp_j, th_j, X0_j = j_exp_fit(B, d=32, seed=SEED, dtype=jnp.float64)
    Xj, _, ij = j_refine.solve_mixed_precision(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=B, bulk_dtype=jnp.bfloat16)
    assert np.asarray(ij.converged).all()
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(X.numpy(), runs["f32"][0].numpy(), rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("kw", [{"bulk_compact": 2}, {"sort_by_difficulty": True, "sort_chunk": 8}],
                         ids=["compact", "sorted"])
def test_bf16_routes_match_plain_bf16_route(kw, family, runs):
    bp, th, X0 = family
    compact.reset_stats()
    X, Y, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=16, bulk_dtype=BF, **kw)
    _certified(info)
    if "bulk_compact" in kw:
        assert compact.STATS and compact.STATS[-1]["lanes"] == B
        # Chunks of 16 against the plain route's one chunk of 32: every op's
        # result per lane is independent of its batch on the CPU.
        assert torch.equal(X, runs["bf16"][0]) and torch.equal(Y, runs["bf16"][1])
    else:
        np.testing.assert_allclose(X.numpy(), runs["bf16"][0].numpy(), rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("kw", [{"certify": "host"}, {"polish": False}], ids=["host", "no_polish"])
def test_bf16_bulk_other_certifications(kw, family, runs):
    bp, th, X0 = family
    X, _, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=B, bulk_dtype=BF, **kw)
    _certified(info)
    # polish=False refines from the bf16 point with the full f64 solver, to
    # its own tolerance (pix ≤ 1.49e-8), not to the polish's digits.
    atol = 1e-8 if kw.get("certify") else 1e-6
    np.testing.assert_allclose(X.numpy(), runs["bf16"][0].numpy(), rtol=1e-7, atol=atol)


# ---------------------------------------------------------------------------
# TF32: SolverOptions.matmul_precision and bulk_matmul_precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", sorted(MATMUL_PRECISIONS))
def test_matmul_precision_values(precision):
    assert SolverOptions(matmul_precision=precision).matmul_precision == precision


@pytest.mark.parametrize("precision", ["bf16_3x", "HIGHEST", "fastest"])
def test_unknown_matmul_precision_raises(precision):
    with pytest.raises(ValueError, match="matmul_precision"):
        SolverOptions(matmul_precision=precision)


def _recording_fns(bp, th, seen, fail_after=None):
    """The family's callables, recording the TF32 flag at every residual
    evaluation (and raising after `fail_after` of them)."""
    fns = bp.instance_fns(th)

    def residuals(x):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        if fail_after is not None and len(seen) > fail_after:
            raise RuntimeError("residuals failed")
        return fns.residuals(x)

    return NLSFunctions(residuals, fns.nlconstraints, fns.jac_res, fns.jac_nlcons)


@pytest.mark.parametrize("before", [False, True])
def test_solve_fixed_point_scopes_tf32(before, family):
    bp, th, X0 = _first(family, 4)
    X0 = X0.float()
    th = {k: v.float() for k, v in th.items()}
    poly = bp.polyhedron(3, torch.float32, 4, X0.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = before
        for precision, want in (("default", True), ("highest", False)):
            seen = []
            opts = SolverOptions(max_outer_iter=3, max_inner_iter=5, matmul_precision=precision)
            outer.solve_fixed_point(_recording_fns(bp, th, seen), poly, X0, opts)
            assert seen and all(s is want for s in seen)
            assert torch.backends.cuda.matmul.allow_tf32 is before
            seen = []
            with pytest.raises(RuntimeError, match="residuals failed"):
                outer.solve_fixed_point(_recording_fns(bp, th, seen, fail_after=2), poly, X0, opts)
            assert seen[-1] is want and torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_bulk_matmul_precision_leaves_certification_without_tf32(family, runs, monkeypatch):
    bp, th, X0 = family
    flags = {"bulk": [], "certify": []}
    loop, polish_fn = outer.outer_loop, polish.polish_then_refine

    def outer_loop(fns, poly, opts, atol, c, *a, **kw):
        if c.x.dtype == torch.float32:     # the bulk; the refine runs in float64
            flags["bulk"].append((torch.backends.cuda.matmul.allow_tf32, opts.matmul_precision))
        return loop(fns, poly, opts, atol, c, *a, **kw)

    def polish_then_refine(*a, **kw):
        flags["certify"].append(torch.backends.cuda.matmul.allow_tf32)
        return polish_fn(*a, **kw)

    monkeypatch.setattr(outer, "outer_loop", outer_loop)
    monkeypatch.setattr(polish, "polish_then_refine", polish_then_refine)
    X, Y, info = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=B, bulk_matmul_precision="default")
    assert flags["bulk"] == [(True, "default")] and flags["certify"] == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    # The CPU has no TF32: the same bits as the "highest" run.
    assert torch.equal(X, runs["f32"][0]) and torch.equal(Y, runs["f32"][1])
    # polish=False drops the knob, as the JAX package does (nothing would
    # absorb a degraded bulk).
    flags["bulk"].clear()
    solve_mixed_precision(*_first(family, 4), SolverOptions(**OPTS), chunk=4, polish=False,
                          bulk_matmul_precision="default")
    assert flags["bulk"] == [(False, "highest")]


def test_solver_options_matmul_precision_reaches_solve(family):
    # Through the public surface: the same bits on the CPU.
    from benlsip_tpu_torch import solve
    from benlsip_tpu_torch.problems import sphere_regression as sr

    out = [solve(sr.make_problem(), sr.x0(dtype=torch.float32, device="cpu"),
                 SolverOptions(max_outer_iter=100, max_inner_iter=250, matmul_precision=p)) for p in ("highest", "default")]
    assert torch.equal(out[0][0], out[1][0]) and bool(out[1][2].converged)
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("kw", [
    {"fuse": True, "bulk_dtype": BF}, {"fuse": True, "bulk_matmul_precision": "default"},
    {"pipeline_overlap": True, "bulk_dtype": BF}, {"pipeline_overlap": True, "bulk_matmul_precision": "default"},
    {"pipeline_overlap": True, "options": SolverOptions(matmul_precision="tensorfloat32")},
    {"bulk_dtype": torch.float16}, {"bulk_matmul_precision": "bf16_3x"},
], ids=["fuse-bf16", "fuse-tf32", "overlap-bf16", "overlap-tf32", "overlap-options-tf32", "float16", "unknown"])
def test_bf16_and_tf32_refusals(kw, family):
    # The JAX package's fused and overlapped dispatches drop these knobs
    # silently; the port refuses them, and every unknown value.
    kw = dict(kw)
    opts = kw.pop("options", SolverOptions(**OPTS))
    with pytest.raises(ValueError):
        solve_mixed_precision(*_first(family, 2), opts, **kw)
