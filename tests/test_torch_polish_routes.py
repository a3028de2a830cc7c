"""`polish_then_refine`'s routes (`split`, `kkt_factorization`,
`fallback_device`, `fallback_pad`) and the problem builders' `dtype`,
held to the JAX package on the CPU.

Inputs: the families from the same numpy recipe in both packages, and the
same float32 bulk point X32 (the port's bulk) handed to both as numpy.
Tolerances:
- a polish route against JAX's: the same certified set, and X within
  rtol 1e-7 / atol 1e-9 on the lanes both certify (the QR factors differ
  in their float32 rounding, MGS here and Householder in XLA, and the f64
  chord steps iterate it away; the bar of `test_torch_certify.py`);
- the all-f64 polish on the port's device route against JAX's
  `sqp_polish` path: the same bar;
- lanes finished by the full-refine fallback: the same converged set and
  X within atol 1e-6 (two f64 solves stopped at pix ≤ 1.49e-8, whose
  trajectories may part at the floor: ROADMAP §3);
- the builders: the same bits of A, b, xl and xu in float32 and float64,
  and the solve's x within atol 1e-7 (the bar of `test_torch_api.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu import solve as j_solve_one
from benlsip_tpu import SolverOptions as JOptions
from benlsip_tpu.batch import polish as jpolish
from benlsip_tpu.problems import generators as jgen
from benlsip_tpu.problems import hs48 as j_hs48
from benlsip_tpu.problems import rosenbrock as j_rosen
from benlsip_tpu.problems import sphere_regression as j_sr
from benlsip_tpu_torch import solve as t_solve_one
from benlsip_tpu_torch.batch import polish as tpolish
from benlsip_tpu_torch.batch.fused_small import solve_small_fused
from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
from benlsip_tpu_torch.batch.vmap_solve import solve_batched
from benlsip_tpu_torch.problems import generators as tgen
from benlsip_tpu_torch.problems import hs48 as t_hs48
from benlsip_tpu_torch.problems import rosenbrock as t_rosen
from benlsip_tpu_torch.problems import sphere_regression as t_sr
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)


def _j32(bp, theta):
    bp32 = dataclasses.replace(bp, **{f: getattr(bp, f).astype(jnp.float32) for f in ("A", "b", "xl", "xu")})
    return bp32, jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, theta)


def _t32(bp, theta):
    return _cast_problem(bp, torch.float32, "cpu"), _cast_tree(theta, torch.float32)


def _pair(make, bulk: dict, **kw):
    """One family in both packages, and the port's float32 bulk's X32."""
    bp_j, th_j, _ = getattr(jgen, make)(**kw)
    bp, th, X0 = getattr(tgen, make)(**kw, device="cpu")
    bp32, th32 = _t32(bp, th)
    X32 = solve_batched(bp32, th32, X0.float(), SolverOptions(**bulk))[0]
    return (bp_j, th_j, *_j32(bp_j, th_j), jnp.asarray(X32.numpy())), (bp, th, bp32, th32, X32), X0


@pytest.fixture(scope="module")
def exp_fit():
    return _pair("exp_fit_family", dict(crit_tol=1e-2, max_outer_iter=40, max_inner_iter=8), B=8, d=32, seed=13)


def _spy(monkeypatch):
    calls = []
    for name in ("sqp_polish_fused", "sqp_polish_split", "sqp_polish"):
        orig = getattr(tpolish, name)
        monkeypatch.setattr(tpolish, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    return calls


def _hold(out_t, out_j, rtol=1e-7, atol=1e-9):
    """The same certified set and X on the lanes both certify."""
    (Xt, _, it), (Xj, _, ij) = out_t, out_j
    okt, okj = it.converged.numpy(), np.asarray(ij.converged)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(it.status.numpy(), np.asarray(ij.status))
    np.testing.assert_allclose(Xt.numpy()[okt], np.asarray(Xj)[okt], rtol=rtol, atol=atol)


# The first polish each (split, n = 3) takes: "on" the split polish, else the
# all-f64 polish ("auto" splits only at n >= 64).
@pytest.mark.parametrize("kkt", ["auto", "lu", "qr"])
@pytest.mark.parametrize("split,want", [("on", "sqp_polish_split"), ("off", "sqp_polish"), ("auto", "sqp_polish")])
def test_host_route_split_and_kkt_match_jax(exp_fit, split, want, kkt, monkeypatch):
    (bp_j, th_j, bp32_j, th32_j, X32_j), (bp, th, bp32, th32, X32), _ = exp_fit
    kw = dict(num_steps=5, device="cpu", split=split, kkt_factorization=kkt)
    out_j = jpolish.polish_then_refine(bp_j, th_j, X32_j, JOptions(**OPTS), bp32=bp32_j, theta32=th32_j, **kw)
    calls = _spy(monkeypatch)
    out_t = tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), bp32=bp32, theta32=th32, **kw)
    assert calls[0] == want and set(calls[1:]) <= {"sqp_polish"}, calls
    assert out_t[0].device.type == "cpu" and bool(out_t[2].converged.all())
    _hold(out_t, out_j)


@pytest.mark.parametrize("kkt", ["lu", "qr"])
def test_device_route_split_off_matches_jax_f64_polish(exp_fit, kkt, monkeypatch):
    # On X32's device (here the CPU) split="off" is the all-f64 polish, as
    # JAX's sqp_polish path; without split="off" it is the fused polish.
    (bp_j, th_j, bp32_j, th32_j, X32_j), (bp, th, bp32, th32, X32), _ = exp_fit
    out_j = jpolish.polish_then_refine(bp_j, th_j, X32_j, JOptions(**OPTS), num_steps=5, device="cpu", bp32=bp32_j,
                                       theta32=th32_j, split="off", kkt_factorization=kkt)
    calls = _spy(monkeypatch)
    out_t = tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), num_steps=5, bp32=bp32, theta32=th32,
                                       split="off", kkt_factorization=kkt)
    assert calls[0] == "sqp_polish", calls
    _hold(out_t, out_j)
    calls.clear()
    tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), num_steps=5, bp32=bp32, theta32=th32, split="on")
    assert calls == ["sqp_polish_fused"], calls


def test_auto_split_at_n64_matches_jax(monkeypatch):
    # At n >= 64 "auto" is the split polish on the host route, in both packages.
    (bp_j, th_j, bp32_j, th32_j, X32_j), (bp, th, bp32, th32, X32), _ = _pair(
        "dense_quadratic_family", dict(crit_tol=1e-2, max_outer_iter=30, max_inner_iter=100),
        B=4, n=64, d=128, m=2, seed=5)
    opts = dict(max_outer_iter=30, max_inner_iter=100)
    out_j = jpolish.polish_then_refine(bp_j, th_j, X32_j, JOptions(**opts), num_steps=5, device="cpu", bp32=bp32_j,
                                       theta32=th32_j)
    calls = _spy(monkeypatch)
    out_t = tpolish.polish_then_refine(bp, th, X32, SolverOptions(**opts), num_steps=5, device="cpu", bp32=bp32,
                                       theta32=th32)
    assert calls[0] == "sqp_polish_split", calls
    assert bool(out_t[2].converged.all())
    _hold(out_t, out_j)


def test_kkt_auto_is_lu_for_f64_on_every_device(exp_fit, monkeypatch):
    # A deliberate difference: the JAX package turns "auto" into "qr" on an
    # accelerator (the TPU had no f64 LU); the port keeps the dtype rule,
    # so the all-f64 polish factors by LU on X32's device as on the CPU.
    _, (bp, th, bp32, th32, X32), _ = exp_fit
    seen = []
    for name in ("qr", "lu"):
        orig = tpolish._FACTOR[name]
        monkeypatch.setitem(tpolish._FACTOR, name, lambda *a, _o=orig, _n=name: seen.append(_n) or _o(*a))
    for device in (None, "cpu"):
        seen.clear()
        tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), num_steps=5, device=device, split="off")
        assert seen and set(seen) == {"lu"}, (device, seen)
    with pytest.raises(ValueError, match="kkt_factorization"):
        tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), kkt_factorization="cholesky")
    with pytest.raises(ValueError, match="split"):
        tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), split="yes")


def test_split_polish_lu_against_qr_ill_conditioned():
    # The split polish's float32 LU holds JᵀJ (κ²·eps(f32) > 1 at κ = 1e4),
    # its QR only κ·eps: through polish_then_refine(split="on", rounds=1)
    # the lanes each certifies in the polish (no outer iteration) are JAX's,
    # and QR certifies more than LU.  The fallback refine's lanes are not
    # compared: on this family its trajectories part at a Cauchy direction
    # of rounding size (ROADMAP §3).
    (bp_j, th_j, bp32_j, th32_j, X32_j), (bp, th, bp32, th32, X32), _ = _pair(
        "ill_conditioned_family", dict(crit_tol=1e-2, max_outer_iter=20, max_inner_iter=80),
        B=8, n=24, d=96, kappa=1e4, seed=9)
    # The polish reads only the tolerances; the inner cap keeps the fallback
    # refine of the lanes the polish leaves short.
    opts = dict(max_outer_iter=20, max_inner_iter=2)
    polished = {}
    for kkt in ("lu", "qr"):
        kw = dict(num_steps=8, device="cpu", rounds=1, split="on", kkt_factorization=kkt)
        Xj, _, ij = jpolish.polish_then_refine(bp_j, th_j, X32_j, JOptions(**opts), bp32=bp32_j, theta32=th32_j, **kw)
        Xt, _, it = tpolish.polish_then_refine(bp, th, X32, SolverOptions(**opts), bp32=bp32, theta32=th32, **kw)
        pol_t = (it.converged & (it.outer_iters == 0)).numpy()
        pol_j = np.asarray(ij.converged) & (np.asarray(ij.outer_iters) == 0)
        np.testing.assert_array_equal(pol_t, pol_j)
        np.testing.assert_allclose(Xt.numpy()[pol_t], np.asarray(Xj)[pol_t], rtol=1e-7, atol=1e-9)
        polished[kkt] = int(pol_t.sum())
    assert polished["lu"] < polished["qr"], polished


def test_fallback_device_matches_jax(exp_fit):
    # A cold start with one factor and one chord step and no re-polish
    # leaves lanes uncertified: the fallback refine runs on fallback_device
    # and the results come back there, as JAX's refine_f64(device=...).
    (bp_j, th_j, bp32_j, th32_j, _), (bp, th, bp32, th32, _), X0 = exp_fit
    X32_j, X32 = X0.numpy().astype(np.float32), X0.float()
    kw = dict(num_steps=2, rounds=1, device="cpu", fallback_pad=64, fallback_device="cpu")
    Xj, _, ij = jpolish.polish_then_refine(bp_j, th_j, jnp.asarray(X32_j), JOptions(**OPTS), **kw)
    Xt, Yt, it = tpolish.polish_then_refine(bp, th, X32, SolverOptions(**OPTS), **kw)
    refined = (it.outer_iters > 0).numpy()
    assert refined.any() and bool(it.converged.all()), refined
    assert all(t.device.type == "cpu" for t in (Xt, Yt, *it))
    np.testing.assert_array_equal(refined, np.asarray(ij.outer_iters) > 0)
    np.testing.assert_array_equal(it.converged.numpy(), np.asarray(ij.converged))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pad", [1, 4, 128])
def test_fallback_pad_refused(exp_fit, pad):
    # Only JAX's default is taken: the port pads no bucket (an XLA
    # compile-cache knob), a deliberate difference, refused alike in all
    # three functions that take it.
    _, (bp, th, bp32, th32, X32), X0 = exp_fit
    opts = SolverOptions(**OPTS)
    with pytest.raises(ValueError, match="deliberate difference"):
        tpolish.polish_then_refine(bp, th, X32, opts, 3, 1e-4, pad)
    X, Y, info = tpolish.polish_then_refine(bp, th, X32, opts)
    with pytest.raises(ValueError, match="deliberate difference"):
        tpolish.fallback_full_refine(bp, th, X, Y, info, opts, pad)
    with pytest.raises(ValueError, match="deliberate difference"):
        solve_small_fused(bp, th, X0, opts, fallback_pad=pad)


BUILDERS = {
    "hs48": (lambda dt: j_hs48.make_problem(dt), lambda dt: t_hs48.make_problem(dt), [3.0, 5.0, -3.0, 2.0, -2.0]),
    "rosenbrock": (lambda dt: j_rosen.make_problem(True, dt), lambda dt: t_rosen.make_problem(True, dt), [-1.2, 1.0]),
    "rosenbrock_chained": (lambda dt: j_rosen.make_chained(4, dt), lambda dt: t_rosen.make_chained(4, dt),
                           [-1.2, 1.0, -1.2, 1.0]),
    "sphere": (lambda dt: j_sr.make_problem(dt), lambda dt: t_sr.make_problem(dt), [1.0, 0.5, 1.5]),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_dtype_matches_jax(name, dtype):
    make_j, make_t, _ = BUILDERS[name]
    pj, pt = make_j(getattr(jnp, dtype)), make_t(getattr(torch, dtype))
    for f in ("A", "b", "xl", "xu"):
        a_j, a_t = getattr(pj, f), getattr(pt, f)
        assert (a_j is None) == (a_t is None), f
        if a_t is not None:
            assert a_t.device.type == "cpu" and a_t.dtype == getattr(torch, dtype), f
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_builder_dtype_solve_matches_jax(dtype):
    # A float64 solve of float32 constraint data sees the f32-rounded data
    # in both packages (`Problem.build` casts to x0's dtype).
    make_j, make_t, x0 = BUILDERS["sphere"]
    opts = dict(max_outer_iter=100, max_inner_iter=250)
    xj, yj, ij = j_solve_one(make_j(getattr(jnp, dtype)), jnp.asarray(x0, jnp.float64), JOptions(**opts))
    xt, yt, it = t_solve_one(make_t(getattr(torch, dtype)), torch.tensor(x0, dtype=torch.float64), SolverOptions(**opts))
    assert bool(it.converged) and bool(ij.converged) and int(it.status) == int(ij.status)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-7)
