"""The scheduling routes of the port's `solve_mixed_precision`
(batch/refine.py): converged-instance compaction (`bulk_compact=2`), the
difficulty-sorted bulk (`sort_by_difficulty`) and the overlapped pipeline
(`pipeline_overlap`, both certify modes), each against the port's plain
route (the same bits on the CPU: every route certifies each lane as the
plain route does) and against the JAX package's same route (certified X
within 1e-8); the routes exclude each other and `fuse=True`; "auto" stays
plain; and the loop-of-solves `solve_sequential` against the batched
solve and the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.batch import refine as j_refine
from benlsip_tpu.batch.vmap_solve import solve_sequential as j_sequential
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit
from benlsip_tpu.solver.options import SolverOptions as JOptions
from benlsip_tpu_torch.batch import compact, refine
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import solve_batched, solve_sequential
from benlsip_tpu_torch.interop import info_to_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = dict(max_outer_iter=40, max_inner_iter=120)
B, CHUNK, SEED = 40, 16, 5          # a ragged last chunk of 8
ROUTES = {
    "compact": {"bulk_compact": 2},
    "sorted": {"sort_by_difficulty": True, "sort_chunk": 8},
    "overlap-device": {"pipeline_overlap": True, "certify": "device"},
    "overlap-host": {"pipeline_overlap": True, "certify": "host"},
}


@pytest.fixture(scope="module")
def family():
    return exp_fit_family(B, d=32, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def plain(family):
    bp, th, X0 = family
    return {certify: solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=CHUNK, certify=certify)
            for certify in ("device", "host")}


def _same(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for f, t, u in zip(a[2]._fields, a[2], b[2]):
        assert torch.equal(t, u), f


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_plain_route(route, family, plain):
    bp, th, X0 = family
    kw = ROUTES[route]
    out = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=CHUNK, **kw)
    assert bool(out[2].converged.all()) and float(out[2].pix.max()) <= 1.49e-8
    _same(out, plain[kw.get("certify", "device")])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax_route(route, family):
    bp, th, X0 = family
    kw = dict(ROUTES[route])
    Xt, _, it = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=CHUNK, **kw)
    # The JAX package resolves certify="auto" on its CPU backend to "host".
    kw.setdefault("certify", "host")
    bp_j, th_j, X0_j = j_exp_fit(B, d=32, seed=SEED, dtype=jnp.float64)
    Xj, _, ij = j_refine.solve_mixed_precision(bp_j, th_j, X0_j, JOptions(**OPTS), chunk=CHUNK, **kw)
    assert info_to_numpy(it)["converged"].all() and np.asarray(ij.converged).all()
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-8)


@pytest.mark.parametrize("knob", [{"bulk_compact": 2}, {"sort_by_difficulty": True}, {"pipeline_overlap": True}])
def test_fuse_with_a_scheduling_knob_raises(knob, family):
    # The JAX pipeline's fused dispatch silently drops these knobs; the port refuses.
    bp, th, X0 = family
    with pytest.raises(ValueError, match="fuse=True"):
        solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), fuse=True, **knob)


@pytest.mark.parametrize("kw", [
    {"bulk_compact": 2, "sort_by_difficulty": True}, {"bulk_compact": 2, "pipeline_overlap": True},
    {"sort_by_difficulty": True, "pipeline_overlap": True}, {"pipeline_overlap": True, "polish": False},
])
def test_routes_exclude_each_other(kw, family):
    bp, th, X0 = family
    with pytest.raises(ValueError):
        solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), **kw)


@pytest.mark.parametrize("B_, chunk", [(1024, 512), (16384, 512), (102400, 128)])
def test_auto_compaction_stays_plain(B_, chunk, family, plain):
    assert refine._resolve_bulk_compact("auto", B_, chunk, True) is None
    assert j_refine._resolve_bulk_compact("auto", B_, chunk, True) is None
    assert refine._resolve_bulk_compact(3, B_, chunk, True) == 3
    bp, th, X0 = family
    compact.reset_stats()
    refine.OVERLAP_STAGES.clear()
    out = solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=CHUNK, bulk_compact="auto", fuse="auto")
    assert compact.STATS == [] and refine.OVERLAP_STAGES == {}
    _same(out, plain["device"])


def test_overlap_records_its_stages(family):
    bp, th, X0 = family
    refine.OVERLAP_STAGES.clear()
    solve_mixed_precision(bp, th, X0, SolverOptions(**OPTS), chunk=CHUNK, pipeline_overlap=True)
    st = refine.OVERLAP_STAGES
    assert set(st) == {"wall_s", "bulk_s", "certify_s"} and 0 < st["bulk_s"] <= st["wall_s"] and st["certify_s"] > 0


def test_solve_sequential_matches_batched_and_jax():
    bp, th, X0 = exp_fit_family(6, d=16, seed=2, device="cpu")
    opts = SolverOptions(**OPTS)
    Xs, Ys, i_s = solve_sequential(bp, th, X0, opts)
    Xb, Yb, ib = solve_batched(bp, th, X0, opts)
    assert Xs.shape == (6, 3) and Ys.shape == (6, 0) and bool(i_s.converged.all())
    torch.testing.assert_close(Xs, Xb, rtol=0, atol=1e-12)
    assert torch.equal(i_s.status, ib.status)
    bp_j, th_j, X0_j = j_exp_fit(6, d=16, seed=2)
    Xj, _, ij = j_sequential(bp_j, th_j, X0_j, JOptions(**OPTS))
    np.testing.assert_array_equal(info_to_numpy(i_s)["status"], np.asarray(ij.status))
    np.testing.assert_allclose(Xs.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)


def _in_threads(fn, n_threads=8):
    """fn() in n_threads threads at once, with a short switch interval;
    every thread must finish within a minute."""
    import sys
    import threading

    errors = []

    def run():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]


def test_host_sync_count_loses_nothing_across_threads():
    from benlsip_tpu_torch import _loops

    mask = torch.ones(4, dtype=torch.bool)
    _loops.reset_host_syncs()
    _in_threads(lambda: [_loops.host_any(mask) for _ in range(2000)])
    assert _loops.HOST_SYNCS == 8 * 2000


def test_autodiff_jacobians_in_threads(family):
    # The overlapped pipeline evaluates Jacobians on two threads at once;
    # forward-mode AD levels are global, so they must take turns.
    bp, th, X0 = family
    fns = bp.instance_fns(th)
    want = fns.jac_res(X0)
    got = []
    _in_threads(lambda: got.extend(fns.jac_res(X0) for _ in range(20)), n_threads=4)
    assert len(got) == 80 and all(torch.equal(J, want) for J in got)
