"""The minor-iteration kernel's wrapper, its plain version and the gate of
`solver/inner.minor_iterate`, on the CPU.

On a CUDA tensor in float32, with H materialized as R whole and no mesh
axis, a minor iteration is one launch of
`kernels.batched_linalg.minor_direction_r`; on a CPU tensor the wrapper runs
its plain version, `solver/inner`'s composition of `projected_cg` and
`linesearch`.  These tests hold that plain version bitwise to the
composition as `minor_iterate` wrote it before the kernel (every CG exit:
solved, bound hit, zero curvature from a rank-deficient R, the lane's own
trip cap, and lanes not active), check that the gate sends the R form alone
to the wrapper and every other form (G, J, row-sharded R, bf16, n over the
kernel's cap, no equalities) to the composition, that a small
config-3-shaped bulk is bitwise the same through the wrapper, and the
wrapper's refusals.  Directions below the curvature test's sqrt(eps) still
hit the box (factor_to_boundary's 1e-10), and a launch hands the C entry
both thresholds and the block's shared-memory count.  The kernel itself
runs on the card only (`chip_smoke.py`, phase 3c).
"""
import functools
import inspect

import numpy as np
import pytest
import torch

from benlsip_tpu_torch.batch.vmap_solve import solve_batched
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops.al import AlHessian, with_gram
from benlsip_tpu_torch.ops.constraints import Polyhedron, make_active_set
from benlsip_tpu_torch.problems.generators import dense_quadratic_family
from benlsip_tpu_torch.solver import cg, inner
from benlsip_tpu_torch.solver.cg import linesearch, projected_cg
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.status import (
    CG_BOUND_HIT, CG_MAX_ITER, CG_NEGATIVE_CURVATURE, CG_SOLVED,
)

torch.set_num_threads(2)
F32 = torch.float32


def _today(x, s, g_minor, H, poly, aset, delta, kappa2, active=None):
    """`minor_iterate` as it was written before the kernel."""
    free = ~aset.fixed
    dl = delta.unsqueeze(-1)
    w_u = torch.where(free, torch.minimum(poly.xu - x, dl) - s, 0.0)
    w_l = torch.where(free, torch.maximum(poly.xl - x, -dl) - s, 0.0)
    w_u = torch.clamp_min(w_u, 0.0)
    w_l = torch.clamp_max(w_l, 0.0)
    w, status, iters = projected_cg(g_minor, H, w_l, w_u, poly, aset, kappa2, active=active)
    alpha = linesearch(g_minor, H, w, w_l, w_u, aset.fixed)
    w = torch.where((status != CG_NEGATIVE_CURVATURE).unsqueeze(-1), alpha.unsqueeze(-1) * w, w)
    return w, status, iters


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# Per lane: the spread of R's singular values (κ(R) = 10**spread), the trust
# radius, and which lanes have a rank-deficient R (half its singular values
# 0) or R = 0 (zero curvature everywhere).
SPREAD = (0.5, 0.5, 3.0, 3.0, 0.5, 0.5, 3.0, 0.5)
DELTA = (10.0, 0.05, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0)
HALF_RANK, ZERO_R = 4, 5


def _cg_cases(seed=0, B=8, n=12, m=2):
    """A batch whose lanes end the CG in every way at kappa2 = 1e-3: solved
    (0, 7), a bound hit (1: a small trust radius; 4: half of R's rank), zero
    curvature (5: R = 0) and the lane's own cap 2(n − m − #fixed) (2, 3:
    κ(H) = 1e6 in float32).  One A shared by the batch (a stride-0 expand),
    shared bounds ±1."""
    rng = np.random.default_rng(seed)
    A = _f32(rng.standard_normal((1, m, n))).expand(B, m, n)
    xl, xu = _f32(-np.ones((1, n))).expand(B, n), _f32(np.ones((1, n))).expand(B, n)
    x = _f32(rng.uniform(-0.5, 0.5, (B, n)))
    s = torch.zeros(B, n)
    g = _f32(rng.standard_normal((B, n)))
    fixed = torch.from_numpy(rng.random((B, n)) < 0.2)
    R = np.zeros((B, n, n))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        sv = np.logspace(0, SPREAD[b], n)
        if b == HALF_RANK:
            sv[: n // 2] = 0
        if b == ZERO_R:
            sv[:] = 0
        R[b] = np.linalg.qr((Q * sv) @ np.linalg.qr(rng.standard_normal((n, n)))[0])[1]
    poly = Polyhedron(A, torch.zeros(B, m), xl, xu)
    return poly, make_active_set(poly, fixed), x, s, g, _f32(DELTA[:B]), _f32(R)


def _kernel_args(poly, aset, x, s, g, delta, R):
    return R, poly.A, aset.chol, aset.fixed, x, s, g, poly.xl, poly.xu, delta


@pytest.mark.parametrize("kappa2", [1e-3, 0.1])
@pytest.mark.parametrize("inactive", [False, True])
def test_plain_version_is_the_composition_bitwise(kappa2, inactive):
    poly, aset, x, s, g, delta, R = _cg_cases()
    active = torch.tensor([True, False, True, True, True, False, True, True]) if inactive else None
    tk.reset_launches()
    got = tk.minor_direction_r(*_kernel_args(poly, aset, x, s, g, delta, R), kappa2, active=active)
    want = _today(x, s, g, AlHessian(None, None, None, R=R), poly, aset, delta, kappa2, active=active)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # minor_iterate on CPU tensors takes the composition: the same bits.
    via_inner = inner.minor_iterate(x, s, g, AlHessian(None, None, None, R=R), poly, aset, delta, kappa2, active=active)
    for a, b in zip(via_inner, want):
        assert torch.equal(a, b)
    assert sum(tk.LAUNCHES.values()) == 0   # CPU tensors never launch
    w, status, iters = got
    if kappa2 == 1e-3 and not inactive:
        assert set(status.tolist()) == {CG_SOLVED, CG_BOUND_HIT, CG_NEGATIVE_CURVATURE, CG_MAX_ITER}
        cap = 2 * (x.shape[1] - poly.A.shape[1] - aset.fixed.sum(-1))
        at_cap = status == CG_MAX_ITER
        assert torch.equal(iters[at_cap], cap[at_cap].to(torch.int32))
        assert status[ZERO_R] == CG_NEGATIVE_CURVATURE and not w[ZERO_R].any()
    if inactive:
        # A lane not active runs no trip: w = 0, its entry status, 0 trips.
        assert not w[~active].any() and not iters[~active].any()
        assert (status[~active] != CG_NEGATIVE_CURVATURE).all()


def _small_cases():
    """`_cg_cases` near criticality: g a ten-thousandth as long (so every
    component of the CG direction lies below sqrt(eps) of float32, 3.45e-4),
    s = 0 and a trust radius of 1e-5 on every lane but lane 0."""
    poly, aset, x, s, g, delta, R = _cg_cases()
    delta = torch.full_like(delta, 1e-5)
    delta[0] = 10.0
    return poly, aset, x, torch.zeros_like(s), g * 1e-4, delta, R


@pytest.mark.parametrize("kappa2", [1e-3, 0.1])
def test_small_directions_still_bind_the_box(kappa2):
    # The box binds every component of the direction above
    # factor_to_boundary's 1e-10, not above the curvature test's sqrt(eps):
    # with directions of ~1e-4 against a box of 1e-5, lanes 1 and 7 end on
    # a bound hit, and would run on to a solve with sqrt(eps) at the box.
    # The kernel passes the same threshold (MINOR_BOUND_ATOL).
    poly, aset, x, s, g, delta, R = _small_cases()
    H = AlHessian(None, None, None, R=R)
    got = tk.minor_direction_r(*_kernel_args(poly, aset, x, s, g, delta, R), kappa2)
    want = _today(x, s, g, H, poly, aset, delta, kappa2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    status = got[1]
    assert (status[[1, 7]] == CG_BOUND_HIT).all()
    eps_half = torch.finfo(F32).eps ** 0.5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cg, "factor_to_boundary", functools.partial(cg.factor_to_boundary, atol=eps_half))
        loose = _today(x, s, g, H, poly, aset, delta, kappa2)[1]
    assert (loose[[1, 7]] == CG_SOLVED).all()
    assert tk.MINOR_BOUND_ATOL == inspect.signature(cg.factor_to_boundary).parameters["atol"].default


def test_launch_carries_both_tolerances_and_the_block_bytes(monkeypatch):
    # The arguments the wrapper hands the C entry for a card (the launch
    # itself spied on): kappa2, the curvature test's sqrt(eps) of float32,
    # factor_to_boundary's threshold, and the block's shared memory, which
    # the entry refuses unless it equals its own count.
    poly, aset, x, s, g, delta, R = _cg_cases(B=4)
    seen = []
    monkeypatch.setattr(tk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tk, "_launch", lambda name, base, t, *args: seen.append((name, base, args)))
    tk.minor_direction_r(*_kernel_args(poly, aset, x, s, g, delta, R), 0.1)
    (name, base, args), = seen
    assert (name, base) == ("minor_direction_r", "benlsip_minor_direction_r")
    kappa2, atol, bound_atol = args[14:17]
    assert kappa2 == 0.1 and atol == torch.finfo(F32).eps ** 0.5 and bound_atol == 1e-10
    B, k, m, n, smem = args[20:]
    assert (B, k, m, n) == (4, 12, 2, 12) and smem == tk.minor_direction_smem(12, 2, 12)


def _forms(form, B=3, n=24, d=60, m=3, seed=1):
    """(x, s, g, H, poly, aset, delta) with H in `form`."""
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if form == "bf16" else F32
    if form == "n_over_cap":
        n, d = 240, 480
    if form == "no_equalities":
        m = 0
    J = _f32(rng.standard_normal((B, d, n)) / np.sqrt(d))
    H = AlHessian(J, torch.zeros(B, 0, n), torch.ones(B))
    R = torch.linalg.qr(J, mode="r").R
    if form in ("R", "n_over_cap", "no_equalities"):
        H = AlHessian(J, H.C, H.mu, R=R)
    elif form == "R_rows":
        H = AlHessian(J, H.C, H.mu, R_rows=R)
    elif form == "G":
        H = with_gram(H)
    elif form == "bf16":
        H = AlHessian(J.to(dtype), H.C.to(dtype), H.mu.to(dtype), R=R.to(dtype))
    A = _f32(rng.standard_normal((B, m, n))).to(dtype)
    poly = Polyhedron(A, torch.zeros(B, m, dtype=dtype), torch.full((B, n), -1.0, dtype=dtype),
                      torch.full((B, n), 1.0, dtype=dtype))
    fixed = torch.from_numpy(rng.random((B, n)) < 0.15)
    x = _f32(rng.uniform(-0.5, 0.5, (B, n))).to(dtype)
    g = _f32(rng.standard_normal((B, n))).to(dtype)
    return x, torch.zeros_like(x), g, H, poly, make_active_set(poly, fixed), torch.full((B,), 2.0, dtype=dtype)


@pytest.mark.parametrize("form", ["R", "G", "J", "R_rows", "bf16", "n_over_cap", "no_equalities"])
def test_gate_sends_the_r_form_alone_to_the_kernel(form, monkeypatch):
    # The gate with its device test answered for a card, and the wrapper
    # spied on: only the float32 R form within the kernel's cap reaches the
    # wrapper (whose CPU path is the plain version), and every route gives
    # the composition's bits.
    gate, calls, wrapper = inner.minor_on_kernel, [], tk.minor_direction_r
    monkeypatch.setattr(inner, "minor_on_kernel", lambda device_type, *a: gate("cuda", *a))
    monkeypatch.setattr(tk, "minor_direction_r", lambda *a, **k: calls.append(a) or wrapper(*a, **k))
    x, s, g, H, poly, aset, delta = _forms(form)
    active = torch.tensor([True, False, True])
    got = inner.minor_iterate(x, s, g, H, poly, aset, delta, 0.1, active=active)
    want = _today(x, s, g, H, poly, aset, delta, 0.1, active=active)
    assert len(calls) == (form == "R")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gate_needs_a_card_and_no_axis():
    x, s, g, H, poly, aset, delta = _forms("R")
    m = poly.A.shape[-2]
    assert inner.minor_on_kernel("cuda", H, F32, m, None)
    assert not inner.minor_on_kernel("cpu", H, F32, m, None)
    assert not inner.minor_on_kernel("cuda", H, F32, m, "block")
    assert not inner.minor_on_kernel("cuda", H, torch.float64, m, None)


@pytest.mark.parametrize("tf32", [False, True])
def test_gate_ignores_the_tf32_permission(tf32, monkeypatch):
    # The kernel computes in float32 FMA whatever
    # torch.backends.cuda.matmul.allow_tf32 says: a bulk run with
    # bulk_matmul_precision="default" takes it on the R form all the same.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    x, s, g, H, poly, aset, delta = _forms("R")
    assert inner.minor_on_kernel("cuda", H, F32, poly.A.shape[-2], None)


@pytest.mark.parametrize("k, m, n, fits", [
    (192, 6, 192, True), (235, 6, 235, True), (236, 6, 236, False), (230, 16, 230, True), (231, 16, 231, False),
    (238, 1, 238, True), (1, 1, 256, True), (1, 1, 257, False), (192, 0, 192, False), (192, 17, 192, False),
    (0, 6, 192, False),
])
def test_fits_is_the_kernels_shared_memory_cap(k, m, n, fits):
    assert tk.minor_direction_fits(k, m, n) is fits
    if 0 < m <= tk.MAX_DIM and 0 < n <= tk.MINOR_THREADS and k > 0:
        assert (tk.minor_direction_smem(k, m, n) <= tk.MAX_DYNAMIC_SMEM) is fits
    assert tk.minor_direction_smem(192, 6, 192) == 155_856   # config 3's block


def _refused(change):
    poly, aset, x, s, g, delta, R = _cg_cases(B=4)
    args = dict(zip(("R", "A", "L", "fixed", "x", "s", "g", "xl", "xu", "delta"),
                    _kernel_args(poly, aset, x, s, g, delta, R)))
    args.update(change(args))
    return args


@pytest.mark.parametrize("what, change, error", [
    ("g's shape", lambda a: {"g": a["g"][:, :-1]}, ValueError),
    ("float64", lambda a: {"x": a["x"].double()}, TypeError),
    ("int mask", lambda a: {"fixed": a["fixed"].to(torch.uint8)}, TypeError),
    ("R transposed", lambda a: {"R": a["R"].mT}, ValueError),
    ("A column-major", lambda a: {"A": a["A"].contiguous().mT.contiguous().mT}, ValueError),
    ("strided bounds", lambda a: {"xu": torch.ones(4, 24)[:, ::2]}, ValueError),
    ("m = 17", lambda a: {"A": torch.zeros(4, 17, 12), "L": torch.zeros(4, 17, 17)}, ValueError),
    ("mixed devices", lambda a: {"delta": a["delta"].to("meta")}, ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, change, error):
    tk.reset_launches()
    args = _refused(change)
    with pytest.raises(error):
        tk.minor_direction_r(*args.values(), 0.1)
    assert sum(tk.LAUNCHES.values()) == 0


def test_empty_batch_and_bounds_read_in_place():
    poly, aset, x, s, g, delta, R = _cg_cases(B=4)
    assert poly.xl.stride(0) == 0 and tk.unit_rows(poly.xl) is poly.xl
    assert tk.unit_rows(torch.ones(4, 24)[:, ::2]).is_contiguous()
    w, status, iters = tk.minor_direction_r(*(t[:0] for t in _kernel_args(poly, aset, x, s, g, delta, R)), 0.1)
    assert w.shape == (0, 12) and status.shape == iters.shape == (0,) and status.dtype == torch.int32


def test_config3_shaped_bulk_is_the_same_through_the_wrapper(monkeypatch):
    # The float32 bulk of a small dense family (the materialized CholeskyQR2
    # operator: n ≥ 64, d ≥ 2n) with the gate answered for a card, so that
    # every minor iteration goes through the wrapper (the plain version on
    # the CPU), against the same bulk through the composition: the same bits.
    bp, th, X0 = dense_quadratic_family(4, n=64, d=160, m=3, seed=2, dtype=F32, device="cpu")
    opts = SolverOptions(max_outer_iter=4, max_inner_iter=12)
    X_ref, Y_ref, info_ref = solve_batched(bp, th, X0, opts)
    gate, calls, wrapper = inner.minor_on_kernel, [], tk.minor_direction_r
    monkeypatch.setattr(inner, "minor_on_kernel", lambda device_type, *a: gate("cuda", *a))
    monkeypatch.setattr(tk, "minor_direction_r", lambda *a, **k: calls.append(a[0].shape) or wrapper(*a, **k))
    X, Y, info = solve_batched(bp, th, X0, opts)
    assert calls and set(calls) == {(4, 64, 64)}
    assert torch.equal(X, X_ref) and torch.equal(info.status, info_ref.status)
    assert torch.equal(info.inner_iters, info_ref.inner_iters)
