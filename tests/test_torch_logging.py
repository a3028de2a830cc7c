"""The port's iteration log (`benlsip_tpu_torch/harness/logging`,
`SolverOptions(verbose=True)`) against the JAX package's.

Both print the reference's three tables (banner, one table per outer
iteration, one row per inner iteration) in the same layout.  The sphere
fixture's log is compared line by line, float64 on the CPU: every line is
equal to the printed digit (the banner's two name lines aside) until the
iterates reach the f64 floor, from the first outer table whose ‖c‖ is below
1e-6 on.  There a trust-region step's reduction sits within ~100 ulps of
m(x) (10·eps·|m| is the ratio test's noise guard), so ‖s‖, ρ, ‖c‖, π and
the number of inner trips are rounding noise and the two packages take
different floor trajectories (ROADMAP.md §3, "rounding-level divergence");
past that line the tables must still agree in count, iteration number,
objective, μ and ω to the printed digit, every AL value must be one the
JAX package printed in the same block, and ‖c‖, π and ‖s‖ must stay below
1e-6.

Batches: the JAX package runs vmap over `lax.while_loop`, so its callbacks
fire for every lane at every trip of the batch, finished lanes included
(rows recomputed from a frozen carry, repeated until the batch's loop
ends).  The port writes the rows of the lanes that run, in lane order
(ROADMAP.md §3, deliberate differences).
"""
import io
import re

import jax
import pytest
import torch

import benlsip_tpu as bj
from benlsip_tpu.batch.vmap_solve import solve_batched as j_solve_batched
from benlsip_tpu.harness import logging as jlog
from benlsip_tpu.problems import generators as jgen
from benlsip_tpu.problems import sphere_regression as jsr

import benlsip_tpu_torch as bt
from benlsip_tpu_torch import _loops
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.batch.vmap_solve import solve_batched
from benlsip_tpu_torch.harness import logging as tlog
from benlsip_tpu_torch.problems import generators as tgen
from benlsip_tpu_torch.problems import sphere_regression as tsr

torch.set_num_threads(2)
SPHERE_OPTS = dict(max_outer_iter=100, max_inner_iter=250)
BATCH_OPTS = dict(max_outer_iter=40, max_inner_iter=120)
FLOOR = 1e-6
# HOST_SYNCS of a verbose=False float64 solve of the sphere fixture on the
# CPU, measured on the tree before verbose was ported.
SPHERE_SYNCS = 331
ROW = re.compile(r"^\s*(\d+)   (\S+)   (\S+)   (\S+)   (\S+)$")


def captured(module, run):
    """What `run()` writes to `module`'s log stream."""
    buf = io.StringIO()
    module.set_log_stream(buf)
    try:
        run()
    finally:
        module.set_log_stream(None)
    return buf.getvalue()


def jax_log(run):
    def go():
        run()
        jax.effects_barrier()

    return captured(jlog, go)


def blocks(text):
    """The log as [(tables, rows)]: block 0 holds the rows before the first
    table; each later block the tables of one outer trip (k and the five
    printed numbers, as strings) and the inner rows after them."""
    out = [([], [])]
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.match(r"^\s+Outer iter (\d+)$", line)
        if m:
            if out[-1][1]:
                out.append(([], []))
            out[-1][0].append((m.group(1), *lines[i + 2].split()))
        elif ROW.match(line):
            out[-1][1].append(ROW.match(line).groups())
    return out


def floor_block(bl):
    """Index of the first block one of whose tables reports ‖c‖ < FLOOR."""
    return next(i for i, (tables, _) in enumerate(bl) if any(float(t[2]) < FLOOR for t in tables))


def assert_floor_blocks_agree(got, want):
    """Past the floor: the same tables by iteration, objective, μ and ω;
    ‖c‖ and π below FLOOR; every row's AL value one that JAX printed in the
    same block, and ‖s‖ below FLOOR."""
    assert len(got) == len(want)
    for (gt, gr), (wt, wr) in zip(got, want):
        assert [(t[0], t[1], t[3], t[5]) for t in gt] == [(t[0], t[1], t[3], t[5]) for t in wt]
        assert all(float(t[2]) < FLOOR and float(t[4]) < FLOOR for t in gt + wt)
        assert {r[1] for r in gr} <= {r[1] for r in wr} and bool(gr) == bool(wr)
        assert all(float(r[2]) < FLOOR for r in gr)


def test_verbose_logging_schema():
    # The port of tests/test_harness.py::test_verbose_logging_schema.
    holder = {}

    def run():
        holder["info"] = bt.solve(tsr.make_problem(), tsr.x0(device="cpu"), bt.SolverOptions(verbose=True, **SPHERE_OPTS))[2]

    out = captured(tlog, run)
    assert "Problem dimensions" in out
    assert "Number of parameters.................:     3" in out
    assert "Number of residuals..................:     4" in out
    assert re.search(r"Outer iter \d+", out)
    assert re.search(r"^\s+\d+\s+\d\.\d{6}e[+-]\d+\s+\d\.\d{2}e", out, re.M)
    assert bool(holder["info"].converged)
    # The banner keeps the reference's width; its name line names the port.
    banner = out.splitlines()[2:9]
    assert all(len(line) == 64 for line in banner) and "benlsip_tpu_torch" in banner[2]


def test_sphere_log_matches_jax_line_by_line():
    # float64 on the CPU (tests/conftest.py turns on JAX's x64).
    want = jax_log(lambda: bj.solve(jsr.make_problem(), jsr.x0(), bj.SolverOptions(verbose=True, **SPHERE_OPTS)))
    got = captured(tlog, lambda: bt.solve(tsr.make_problem(), tsr.x0(device="cpu"),
                                          bt.SolverOptions(verbose=True, **SPHERE_OPTS)))
    gl, wl = got.splitlines(), want.splitlines()
    # The banner: the same lines but the two that name the package.
    assert [i for i, (a, b) in enumerate(zip(gl[:25], wl[:25])) if a != b] == [4, 6]
    assert [len(a) for a in gl[:9]] == [len(b) for b in wl[:9]]
    # Every line up to the numbers of the first table at the floor.
    gb, wb = blocks(got), blocks(want)
    cut = floor_block(wb)
    assert floor_block(gb) == cut and cut >= 6
    head = wl.index(f"                          Outer iter {wb[cut][0][0][0]}") + 1
    assert gl[25:head + 1] == wl[25:head + 1]
    assert gl[head + 1].split()[0] == wl[head + 1].split()[0]            # the objective
    assert gb[cut][0][0][3:] == wb[cut][0][0][3:]                        # μ, π and ω
    assert_floor_blocks_agree(gb[cut:], wb[cut:])


def lane_rows(rows, B):
    """JAX rows of a block, one list per lane (the callback of every lane
    at every trip, lanes in order); a finished lane's trailing run of equal
    rows (two or more) is its ghost rows, and a single last row after a
    different one may be a ghost too.  Returns (real rows, ambiguous last
    row or None) per lane."""
    out = []
    for lane in range(B):
        r = rows[lane::B]
        j = len(r)
        while j >= 2 and r[j - 1] == r[j - 2]:
            j -= 1
        if j < len(r):
            out.append((r[:j - 1], None))
        else:
            out.append((r[:-1], r[-1]))
    return out


def test_batch_log_matches_jax_for_the_running_lanes():
    # sphere_family(2, seed=1): both lanes run 8 outer trips, their inner
    # loops stop at different trips.  The port prints one row per running
    # lane per trip, in lane order; JAX also prints the finished lane's.
    B = 2
    bpj, thj, Xj = jgen.sphere_family(B, seed=1)
    want = jax_log(lambda: j_solve_batched(bpj, thj, Xj, bj.SolverOptions(verbose=True, **BATCH_OPTS)))
    bp, th, X0 = tgen.sphere_family(B, seed=1, device="cpu")
    holder = {}

    def run():
        holder["info"] = solve_batched(bp, th, X0, bt.SolverOptions(verbose=True, **BATCH_OPTS))[2]

    got = captured(tlog, run)
    info = holder["info"]
    assert "Problem dimensions" not in got and "Problem dimensions" not in want    # the banner is `solve`'s
    gb, wb = blocks(got), blocks(want)
    assert len(want.splitlines()) == 192 and info.outer_iters.tolist() == [8, 8]
    assert sum(len(r) for _, r in gb) == int(info.inner_iters.sum())   # one row per lane per inner iteration
    assert sum(len(r) for _, r in wb) > sum(len(r) for _, r in gb)
    cut = floor_block(wb)
    assert floor_block(gb) == cut
    for (gt, gr), (wt, wr) in zip(gb[:cut], wb[:cut]):
        assert gt == wt
        # Trip by trip, the rows of the lanes that ran it (k counts the trips).
        lanes = lane_rows(wr, B)
        expect = []
        for trip in range(max(len(real) + 1 for real, _ in lanes)):
            for real, maybe in lanes:
                if trip < len(real):
                    expect.append((real[trip], False))
                elif trip == len(real) and maybe is not None:
                    expect.append((maybe, True))
        rows = iter(gr)
        row = next(rows, None)
        for want_row, optional in expect:
            if row == want_row:
                row = next(rows, None)
            else:
                assert optional, (want_row, row)
        assert row is None
    assert_floor_blocks_agree(gb[cut:], wb[cut:])


def test_batch_log_skips_finished_lanes():
    # exp_fit_family(4, seed=13): the lanes stop after 7, 5, 5 and 6 outer
    # iterations.  The port writes a table for a lane only while it runs;
    # the JAX package writes one for every lane at every trip of the batch.
    bpj, thj, Xj = jgen.exp_fit_family(4, d=32, seed=13)
    want = jax_log(lambda: j_solve_batched(bpj, thj, Xj, bj.SolverOptions(verbose=True, **BATCH_OPTS)))
    bp, th, X0 = tgen.exp_fit_family(4, d=32, seed=13, device="cpu")
    holder = {}

    def run():
        holder["info"] = solve_batched(bp, th, X0, bt.SolverOptions(verbose=True, **BATCH_OPTS))[2]

    got = captured(tlog, run)
    outer = holder["info"].outer_iters.tolist()
    assert outer == [7, 5, 5, 6]
    labels = [int(k) for tables, _ in blocks(got) for k, *_ in tables]
    # Outer iteration k ends with the table "Outer iter k + 1" of each lane
    # that ran it, in lane order.
    assert labels == [k + 1 for k in range(1, max(outer) + 1) for o in outer if o >= k]
    assert want.count("Outer iter") == 4 * max(outer)
    assert sum(len(r) for _, r in blocks(got)) == int(holder["info"].inner_iters.sum())


def test_verbose_refused_under_capture_and_all_trips():
    # A WHILE node's body cannot write on the host: fuse=True refuses
    # verbose=True up front (on the CPU too, where its stages run as plain
    # calls), before any capture; a loop run in "all_trips" mode refuses it
    # at its first row.  Without verbose both run.
    bp, th, X0 = tgen.exp_fit_family(4, d=8, seed=0, device="cpu")
    opts = bt.SolverOptions(verbose=True, max_outer_iter=3, max_inner_iter=4)
    with pytest.raises(ValueError, match="verbose"):
        solve_mixed_precision(bp, th, X0, opts, fuse=True)
    bp32, th32, X32 = tgen.exp_fit_family(4, d=8, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="verbose"), _loops.loop_mode("all_trips"):
        solve_batched(bp32, th32, X32, opts)
    X = solve_mixed_precision(bp, th, X0, bt.SolverOptions(max_outer_iter=3, max_inner_iter=4), fuse=True)[0]
    assert X.shape == X0.shape


def test_verbose_false_adds_no_host_sync():
    _loops.reset_host_syncs()
    info = bt.solve(tsr.make_problem(), tsr.x0(device="cpu"), bt.SolverOptions(**SPHERE_OPTS))[2]
    assert bool(info.converged)
    assert _loops.HOST_SYNCS == SPHERE_SYNCS
    # verbose=True adds one sync per trip of each loop that writes a row.
    _loops.reset_host_syncs()
    out = captured(tlog, lambda: bt.solve(tsr.make_problem(), tsr.x0(device="cpu"),
                                          bt.SolverOptions(verbose=True, **SPHERE_OPTS)))
    rows = sum(1 + len(r) for _, r in blocks(out)) - 1
    assert _loops.HOST_SYNCS == SPHERE_SYNCS + rows
