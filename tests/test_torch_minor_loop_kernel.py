"""The minor-loop kernel's wrapper, its plain version and the gate of
`solver/inner.inner_step`, on the CPU.

On a CUDA tensor in float32, with H materialized as R whole and no mesh
axis, the whole minor loop of an inner step is one launch of
`kernels.batched_linalg.minor_loop_r`; on a CPU tensor the wrapper runs its
plain version, `solver/inner.minor_loop_r_plain`, the masked loop over
`minor_iterate`.  These tests hold that plain version, and `inner_step`
around it, bitwise to the loop as `inner_step` wrote it before the kernel (a
frozen copy below) on config-3-shaped and densesphere-shaped operators, with
lanes whose fixed union overflows, lanes inactive or approx_solved at entry,
a negative-curvature stop and caps of 0 and 1 trips; check that the gate
sends the R form alone to the wrapper and every other form (G, J,
row-sharded R, bf16, n over the kernel's cap, no equalities) to the masked
loop; that small densequad and densesphere bulks give the same bits through
the wrapper; and the wrapper's refusals and the arguments a launch hands the
C entry.  The kernel itself runs on the card only (`chip_smoke.py`, phase 3c).
"""
import dataclasses
import json
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benlsip_tpu_torch._batched import full, sel  # noqa: E402
from benlsip_tpu_torch._loops import masked_while  # noqa: E402
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, nlcons_bulk_options  # noqa: E402
from benlsip_tpu_torch.batch.vmap_solve import solve_batched  # noqa: E402
from benlsip_tpu_torch.kernels import batched_linalg as tk  # noqa: E402
from benlsip_tpu_torch.ops.al import AlHessian, hv, vhv  # noqa: E402
from benlsip_tpu_torch.ops.constraints import (  # noqa: E402
    ActiveSet, Polyhedron, active_bounds_at, make_active_set, nb_fix, sqrt_eps, step_active_bounds,
)
from benlsip_tpu_torch.ops.project import norm_reduced_gradient  # noqa: E402
from benlsip_tpu_torch.problems.generators import dense_quadratic_family  # noqa: E402
from benlsip_tpu_torch.solver import inner  # noqa: E402
from benlsip_tpu_torch.solver.options import SolverOptions  # noqa: E402
from benlsip_tpu_torch.solver.status import CG_NEGATIVE_CURVATURE, CG_RUNNING  # noqa: E402
from portbench.families import densesphere  # noqa: E402
from test_torch_minor_kernel import _forms  # noqa: E402   the operator forms of the iteration kernel's gate test

torch.set_num_threads(2)
F32 = torch.float32
ATOL = sqrt_eps(F32)
KAPPA2, KAPPA3 = 0.1, 0.1


class _TodayCarry(NamedTuple):
    s: torch.Tensor
    g_minor: torch.Tensor
    fixed: torch.Tensor
    chol: torch.Tensor
    j: torch.Tensor
    cg_total: torch.Tensor
    approx_solved: torch.Tensor
    cg_stop: torch.Tensor


def _today_loop(x, g, H, poly, delta, s0, g_minor0, aset0, approx0, max_minor, active, trip_cap,
                kappa2=KAPPA2, kappa3=KAPPA3, atol=ATOL, chol_reg=0.0):
    """`inner_step`'s minor loop as it was written before the kernel."""
    B, n = x.shape
    m = poly.A.shape[-2]
    c = _TodayCarry(s0, g_minor0, aset0.fixed, aset0.chol, full(B, 1, delta, torch.int32),
                    full(B, 0, delta, torch.int32), approx0, full(B, False, delta, torch.bool))

    def cond(c):
        return (c.j <= max_minor) & (~c.approx_solved) & (~c.cg_stop)

    def body(c, act):
        aset = ActiveSet(fixed=c.fixed, chol=c.chol)
        w, cg_status, cg_iters = inner.minor_iterate(x, c.s, c.g_minor, H, poly, aset, delta, kappa2, active=act)
        cg_stop = cg_status == CG_NEGATIVE_CURVATURE
        s = c.s + w
        g_minor = hv(H, s) + g
        at_bound = step_active_bounds(poly, x, s, delta, atol)
        union_fixed = c.fixed | at_bound
        fits = m + union_fixed.sum(-1) <= n
        fixed = sel(fits, union_fixed, active_bounds_at(poly, x + s, atol))
        aset_next = make_active_set(poly, fixed, reg=chol_reg)
        nrg = norm_reduced_gradient(poly, aset_next, g)
        nrgm = norm_reduced_gradient(poly, aset_next, g_minor)
        approx_solved = torch.where(fits, nrgm <= kappa3 * nrg, True)
        return _TodayCarry(s, g_minor, fixed, aset_next.chol, c.j + 1, c.cg_total + cg_iters, approx_solved, cg_stop)

    if trip_cap > 0:
        c = masked_while(cond, body, c, active & cond(c), trip_cap)
    return c


def _today_inner_step(x, g, H, poly, delta, opts, atol, active=None):
    """`inner_step` as it was written before the kernel."""
    B, n = x.shape
    m = poly.A.shape[-2]
    if active is None:
        active = torch.ones(B, dtype=torch.bool)
    if n - m > opts.projected_cauchy_threshold:
        s0, aset0 = inner.cauchy_step_projected(x, g, H, poly, delta, atol, kappa1=opts.kappa1, gamma_c=opts.gamma_c,
                                                max_trials=opts.cauchy_max_trials, chol_reg=opts.chol_reg,
                                                active=active)
    else:
        s0, aset0 = inner.cauchy_step(x, g, H, poly, delta, atol, opts.chol_reg, active=active)
    g_minor0 = hv(H, s0) + g
    nrg0 = norm_reduced_gradient(poly, aset0, g)
    nrgm0 = norm_reduced_gradient(poly, aset0, g_minor0)
    max_minor = torch.clamp_max(torch.clamp_min(n - m - nb_fix(aset0), 0), opts.max_minor_iter)
    c = _today_loop(x, g, H, poly, delta, s0, g_minor0, aset0, nrgm0 <= opts.kappa3 * nrg0, max_minor, active,
                    min(opts.max_minor_iter, n - m), opts.kappa2, opts.kappa3, atol, opts.chol_reg)
    pred = (g * c.s).sum(-1) + 0.5 * vhv(H, c.s)
    return c.s, pred, ActiveSet(fixed=c.fixed, chol=c.chol), inner.InnerStats(c.j - 1, c.cg_total)


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _same(a, b):
    """Bitwise equal, dtype and NaNs included (a lane whose every column is
    fixed has A Z Aᵀ = 0 and a NaN factor)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


# Lanes of `_loop_case`: 0-1 run to their own exits (1 with g a fiftieth as
# long, so that its CG takes interior steps); 2 a trust radius below
# atol / 2, so every coordinate is at the box after its first trip and the
# union of the fixed set overflows (fits false); 3 not active at entry; 4
# approx_solved at entry; 5 R = 0 (the CG meets zero curvature: a
# negative-curvature stop); 6 and 7 capped at 0 and 1 trips.
OVERFLOW, INACTIVE, SOLVED, NEG_CURV, CAP0, CAP1 = 2, 3, 4, 5, 6, 7


def _loop_case(kind, B=8, n=24, d=60, m=3, seed=0):
    """(x, g, H, poly, delta) and the loop's entry carry for `kind`: R the
    triangular factor of J (config 3's operator, "config3") or of
    [J; √μ·C] with C = 2xᵀ, the sphere's Jacobian at x, and μ = 10
    (densesphere's AL operator, "densesphere"); one A shared by the batch,
    shared bounds ±0.8, x inside them, 15% of the columns fixed at entry,
    s0 a small step and g_minor0 = R^T R s0 + g."""
    rng = np.random.default_rng(seed)
    x = _f32(rng.uniform(-0.6, 0.6, (B, n)))
    J = rng.standard_normal((B, d, n)) / np.sqrt(d)
    if kind == "densesphere":
        J = np.concatenate([J, np.sqrt(10.0) * 2.0 * x.double().numpy()[:, None, :]], axis=1)
    R = torch.linalg.qr(torch.from_numpy(J), mode="r").R.float().contiguous()
    R[NEG_CURV] = 0.0
    H = AlHessian(None, None, None, R=R)
    A = _f32(rng.standard_normal((1, m, n)) / np.sqrt(n)).expand(B, m, n)
    poly = Polyhedron(A, torch.zeros(B, m), _f32(np.full((1, n), -0.8)).expand(B, n),
                      _f32(np.full((1, n), 0.8)).expand(B, n))
    g = _f32(rng.standard_normal((B, n)) * np.where(np.arange(B) == 1, 0.02, 1.0)[:, None])
    delta = _f32(np.where(np.arange(B) == OVERFLOW, 1e-5, 0.3))
    aset0 = make_active_set(poly, torch.from_numpy(rng.random((B, n)) < 0.15))
    s0 = torch.where(aset0.fixed, 0.0, _f32(1e-3 * rng.standard_normal((B, n))))
    s0[OVERFLOW] = 0.0
    g_minor0 = hv(H, s0) + g
    max_minor = torch.full((B,), 6, dtype=torch.int32)
    max_minor[CAP0], max_minor[CAP1] = 0, 1
    approx0 = torch.zeros(B, dtype=torch.bool)
    approx0[SOLVED] = True
    active = torch.ones(B, dtype=torch.bool)
    active[INACTIVE] = False
    return (x, g, H, poly, delta), (s0, g_minor0, aset0, approx0, max_minor, active)


def _run_mask(approx0, max_minor, active):
    return active & (max_minor >= 1) & ~approx0


@pytest.mark.parametrize("kind", ["config3", "densesphere"])
def test_plain_version_is_todays_loop_bitwise(kind):
    (x, g, H, poly, delta), (s0, g_minor0, aset0, approx0, max_minor, active) = _loop_case(kind)
    n, m = x.shape[1], poly.A.shape[1]
    want = _today_loop(x, g, H, poly, delta, s0, g_minor0, aset0, approx0, max_minor, active, min(50, n - m))
    tk.reset_launches()
    got = tk.minor_loop_r(H.R, poly.A, aset0.chol, aset0.fixed, x, s0, g, g_minor0, poly.xl, poly.xu, delta,
                          _run_mask(approx0, max_minor, active), max_minor, KAPPA2, KAPPA3, ATOL)
    assert sum(tk.LAUNCHES.values()) == 0   # CPU tensors never launch
    s, g_minor, fixed, L, iters, cg_iters, status = got
    for a, b in ((s, want.s), (g_minor, want.g_minor), (fixed, want.fixed), (L, want.chol), (iters, want.j - 1),
                 (cg_iters, want.cg_total), (status == CG_NEGATIVE_CURVATURE, want.cg_stop)):
        assert _same(a, b)
    assert iters.dtype == cg_iters.dtype == status.dtype == torch.int32
    # Lane 0 runs several trips, lane 1 CG trips inside them; the
    # overflowing union (every coordinate within atol of a trust radius of
    # 1e-5, none at ±0.8) ends its lane after one trip with the bounds active
    # at x + s; the negative-curvature stop after one; lanes not run keep
    # their entry carry.
    assert iters[0] >= 2 and cg_iters[:2].sum() > 0
    assert iters[OVERFLOW] == 1 and max_minor[OVERFLOW] > 1 and status[OVERFLOW] != CG_NEGATIVE_CURVATURE
    assert torch.equal(fixed[OVERFLOW], active_bounds_at(poly, x + s, ATOL)[OVERFLOW])
    assert step_active_bounds(poly, x, s, delta, ATOL)[OVERFLOW].all() and not fixed[OVERFLOW].any()
    assert iters[NEG_CURV] == 1 and status[NEG_CURV] == CG_NEGATIVE_CURVATURE
    assert iters[CAP1] == 1
    for lane in (INACTIVE, SOLVED, CAP0):
        assert iters[lane] == 0 and cg_iters[lane] == 0 and status[lane] == CG_RUNNING
        assert torch.equal(s[lane], s0[lane]) and torch.equal(fixed[lane], aset0.fixed[lane])
        assert torch.equal(L[lane], aset0.chol[lane]) and torch.equal(g_minor[lane], g_minor0[lane])


@pytest.mark.parametrize("kind", ["config3", "densesphere"])
@pytest.mark.parametrize("max_minor_iter", [0, 1, 50])
def test_inner_step_is_todays_inner_step_bitwise(kind, max_minor_iter, monkeypatch):
    # The whole inner step, on the CPU and with the gate answered for a card
    # (every minor loop through the wrapper, whose CPU path is the plain
    # version), against the frozen copy: the same bits.
    (x, g, H, poly, delta), (_, _, _, _, _, active) = _loop_case(kind)
    # config3 takes the projected Cauchy search, densesphere the breakpoint walk.
    opts = SolverOptions(max_minor_iter=max_minor_iter, projected_cauchy_threshold=16 if kind == "config3" else 32)
    want = _today_inner_step(x, g, H, poly, delta, opts, ATOL, active=active)
    cpu = inner.inner_step(x, g, H, poly, delta, opts, ATOL, active=active)
    gate, calls, wrapper = inner.minor_on_kernel, [], tk.minor_loop_r
    monkeypatch.setattr(inner, "minor_on_kernel", lambda device_type, *a: gate("cuda", *a))
    monkeypatch.setattr(tk, "minor_loop_r", lambda *a, **k: calls.append(a[0].shape) or wrapper(*a, **k))
    via = inner.inner_step(x, g, H, poly, delta, opts, ATOL, active=active)
    assert len(calls) == (max_minor_iter > 0)
    for got in (cpu, via):
        s, pred, aset, stats = got
        for a, b in ((s, want[0]), (pred, want[1]), (aset.fixed, want[2].fixed), (aset.chol, want[2].chol),
                     (stats.minor_iters, want[3].minor_iters), (stats.cg_iters, want[3].cg_iters)):
            assert _same(a, b)
    if max_minor_iter == 1:
        assert int(want[3].minor_iters.max()) == 1
    if max_minor_iter == 50:
        assert int(want[3].minor_iters.max()) >= 2


@pytest.mark.parametrize("form", ["R", "G", "J", "R_rows", "bf16", "n_over_cap", "no_equalities"])
def test_gate_sends_the_r_form_alone_to_the_loop_kernel(form, monkeypatch):
    # The gate with its device test answered for a card, and the wrapper
    # spied on: only the float32 R form within the kernel's cap reaches the
    # wrapper, and every route gives the frozen inner step's bits.
    gate, calls, wrapper = inner.minor_on_kernel, [], tk.minor_loop_r
    monkeypatch.setattr(inner, "minor_on_kernel", lambda device_type, *a: gate("cuda", *a))
    monkeypatch.setattr(tk, "minor_loop_r", lambda *a, **k: calls.append(a) or wrapper(*a, **k))
    x, _, g, H, poly, _, delta = _forms(form)
    opts = SolverOptions(max_minor_iter=3)
    active = torch.tensor([True, False, True])
    got = inner.inner_step(x, g, H, poly, delta, opts, ATOL, active=active)
    want = _today_inner_step(x, g, H, poly, delta, opts, ATOL, active=active)
    assert len(calls) == (form == "R")
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[2].fixed, want[2].fixed) and _same(got[2].chol, want[2].chol)
    assert _same(got[3].minor_iters, want[3].minor_iters) and _same(got[3].cg_iters, want[3].cg_iters)


def _loop_args(B=4):
    (x, g, H, poly, delta), (s0, g_minor0, aset0, approx0, max_minor, active) = _loop_case("config3", B=8)
    names = ("R", "A", "L", "fixed", "x", "s", "g", "g_minor", "xl", "xu", "delta", "run", "max_minor")
    vals = (H.R, poly.A, aset0.chol, aset0.fixed, x, s0, g, g_minor0, poly.xl, poly.xu, delta,
            _run_mask(approx0, max_minor, active), max_minor)
    return {k: v[:B] for k, v in zip(names, vals)}


@pytest.mark.parametrize("what, change, error", [
    ("g_minor's shape", lambda a: {"g_minor": a["g_minor"][:, :-1]}, ValueError),
    ("float64", lambda a: {"s": a["s"].double()}, TypeError),
    ("int mask", lambda a: {"fixed": a["fixed"].to(torch.uint8)}, TypeError),
    ("int run", lambda a: {"run": a["run"].to(torch.int32)}, TypeError),
    ("int64 max_minor", lambda a: {"max_minor": a["max_minor"].long()}, TypeError),
    ("max_minor's shape", lambda a: {"max_minor": a["max_minor"][:-1]}, ValueError),
    ("R transposed", lambda a: {"R": a["R"].mT}, ValueError),
    ("strided g_minor", lambda a: {"g_minor": torch.ones(4, 48)[:, ::2]}, ValueError),
    ("m = 17", lambda a: {"A": torch.zeros(4, 17, 24), "L": torch.zeros(4, 17, 17)}, ValueError),
    ("mixed devices", lambda a: {"max_minor": a["max_minor"].to("meta")}, ValueError),
])
def test_loop_wrapper_refuses_what_the_kernel_does_not_take(what, change, error):
    tk.reset_launches()
    args = _loop_args()
    args.update(change(args))
    with pytest.raises(error):
        tk.minor_loop_r(*args.values(), KAPPA2, KAPPA3, ATOL)
    assert sum(tk.LAUNCHES.values()) == 0


def test_loop_launch_carries_the_tolerances_and_the_block_bytes(monkeypatch):
    # The arguments the wrapper hands the C entry for a card (the launch
    # itself spied on): kappa2, kappa3, the curvature test's sqrt(eps) of
    # float32, factor_to_boundary's threshold, the bound masks' atol, the
    # factor's jitter, and the block's shared memory, the minor iteration's
    # layout, which the entry refuses unless it equals its own count.
    args = _loop_args()
    seen = []
    monkeypatch.setattr(tk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tk, "_launch", lambda name, base, t, *a: seen.append((name, base, a)))
    tk.minor_loop_r(*args.values(), 0.1, 0.25, 1e-4, 1e-3)
    (name, base, a), = seen
    assert (name, base) == ("minor_loop_r", "benlsip_minor_loop_r")
    assert len(a) == len(tk._SIGNATURES["benlsip_minor_loop_r"]) - 1   # the stream is added by _launch
    kappa2, kappa3, atol, bound_atol, fix_atol, reg = a[16:22]
    assert (kappa2, kappa3, fix_atol, reg) == (0.1, 0.25, 1e-4, 1e-3)
    assert atol == torch.finfo(F32).eps ** 0.5 and bound_atol == tk.MINOR_BOUND_ATOL == 1e-10
    B, k, m, n, smem = a[29:]
    assert (B, k, m, n) == (4, 24, 3, 24) and smem == tk.minor_direction_smem(24, 3, 24)
    assert a[14] == args["run"].data_ptr() and a[15] == args["max_minor"].data_ptr()


def test_loop_wrapper_empty_batch_and_every_lane_running():
    args = _loop_args()
    out = tk.minor_loop_r(*(v[:0] for v in args.values()), KAPPA2, KAPPA3, ATOL)
    assert out[0].shape == (0, 24) and out[3].shape == (0, 3, 3) and all(t.shape == (0,) for t in out[4:])
    # run=None runs every lane at entry, as a mask of all True does.
    args["max_minor"] = torch.full((4,), 3, dtype=torch.int32)
    every = dict(args, run=torch.ones(4, dtype=torch.bool))
    a = tk.minor_loop_r(*dict(args, run=None).values(), KAPPA2, KAPPA3, ATOL)
    b = tk.minor_loop_r(*every.values(), KAPPA2, KAPPA3, ATOL)
    assert all(torch.equal(u, v) for u, v in zip(a, b)) and (a[4] >= 1).all()


def _through_the_wrapper(monkeypatch, solve):
    """solve() with the composition, then with the gate answered for a card
    and `minor_loop_r` spied on: both results and the wrapper's R shapes."""
    ref = solve()
    gate, calls, wrapper = inner.minor_on_kernel, [], tk.minor_loop_r
    monkeypatch.setattr(inner, "minor_on_kernel", lambda device_type, *a: gate("cuda", *a))
    monkeypatch.setattr(tk, "minor_loop_r", lambda *a, **k: calls.append(tuple(a[0].shape)) or wrapper(*a, **k))
    return ref, solve(), calls


def test_densequad_bulk_is_the_same_through_the_loop_wrapper(monkeypatch):
    # The float32 bulk of a small dense family (the materialized CholeskyQR2
    # operator: n ≥ 64, d ≥ 2n): every inner step's minor loop through the
    # wrapper against the masked loop: the same bits.
    bp, th, X0 = dense_quadratic_family(4, n=64, d=160, m=3, seed=2, dtype=F32, device="cpu")
    opts = SolverOptions(max_outer_iter=4, max_inner_iter=12)
    (X_ref, _, info_ref), (X, _, info), calls = _through_the_wrapper(monkeypatch, lambda: solve_batched(bp, th, X0, opts))
    assert calls and set(calls) == {(4, 64, 64)}
    assert torch.equal(X, X_ref) and torch.equal(info.status, info_ref.status)
    assert torch.equal(info.inner_iters, info_ref.inner_iters)


def test_densesphere_bulk_is_the_same_through_the_loop_wrapper(monkeypatch):
    # The benchmark's norm-constrained family at a CPU size (n = 64, so the
    # AL operator [J; √μ·C] is materialized as R) through its f32 bulk
    # options: the same bits through the wrapper as through the masked loop.
    cfg = json.loads((ROOT / "portbench" / "configs" / "densesphere-n192-d1024-m6-p1.json").read_text())
    pool = densesphere.Pool({**cfg, "n": 64, "d": 160, "m": 3}, {"batch": 4, "pool": 1, "start": "cold"},
                            2_718_281_828_459, torch.device("cpu"))
    bp, th, X0 = pool.batch(0)
    bp32, th32 = _cast_problem(bp, F32, "cpu"), _cast_tree(th, F32)
    opts = nlcons_bulk_options(dataclasses.replace(SolverOptions(**cfg["options"]), max_outer_iter=3, max_inner_iter=10),
                               bp32, 1e-2)
    (X_ref, Y_ref, info_ref), (X, Y, info), calls = _through_the_wrapper(
        monkeypatch, lambda: solve_batched(bp32, th32, X0.float(), opts))
    assert calls and set(calls) == {(4, 64, 64)}
    assert torch.equal(X, X_ref) and torch.equal(Y, Y_ref) and torch.equal(info.status, info_ref.status)
    assert torch.equal(info.inner_iters, info_ref.inner_iters)
