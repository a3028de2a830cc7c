"""Package hygiene of the PyTorch port: it never imports jax, its options
table matches the JAX package's field by field, knobs whose route is not
ported raise instead of silently running another path, and the interop
helpers carry data across."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import benlsip_tpu
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.batch.polish import polish_then_refine
from benlsip_tpu_torch.interop import info_to_numpy, problem_from_numpy, theta_from_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family, _exp_fit_residuals
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.subproblem import resolve_operator_route

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "benlsip_tpu_torch",
    "benlsip_tpu_torch.interop",
    "benlsip_tpu_torch.kernels.batched_linalg",
    "benlsip_tpu_torch.ops.al",
    "benlsip_tpu_torch.ops.cholesky",
    "benlsip_tpu_torch.ops.constraints",
    "benlsip_tpu_torch.ops.polyproject",
    "benlsip_tpu_torch.ops.project",
    "benlsip_tpu_torch.ops.qr",
    "benlsip_tpu_torch.solver.api",
    "benlsip_tpu_torch.solver.cg",
    "benlsip_tpu_torch.solver.inner",
    "benlsip_tpu_torch.solver.multipliers",
    "benlsip_tpu_torch.solver.options",
    "benlsip_tpu_torch.solver.outer",
    "benlsip_tpu_torch.solver.status",
    "benlsip_tpu_torch.solver.subproblem",
    "benlsip_tpu_torch.batch.vmap_solve",
    "benlsip_tpu_torch.batch.polish",
    "benlsip_tpu_torch.batch.refine",
    "benlsip_tpu_torch.problems.generators",
]


def test_port_never_imports_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'benlsip_tpu.')) or k == 'benlsip_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_options_match_jax_field_by_field():
    j_fields = {f.name: f.default for f in dataclasses.fields(benlsip_tpu.SolverOptions)}
    t_fields = {f.name: f.default for f in dataclasses.fields(SolverOptions)}
    assert j_fields.pop("unroll_limit") == 0   # not ported: an XLA compile-time knob
    assert t_fields == j_fields
    for dt, jd in ((torch.float32, "float32"), (torch.float64, "float64")):
        t = SolverOptions().resolve_tols(dt)
        j = benlsip_tpu.SolverOptions().resolve_tols(np.dtype(jd))
        assert t.crit_tol == j.crit_tol and t.feas_tol == j.feas_tol
    with pytest.raises(ValueError):
        SolverOptions(eta1=0.9, eta2=0.5)


@pytest.mark.parametrize("knob", [
    {"spmd_axis": "x"}, {"gram_layout": "sharded"}, {"reduce_schedule": "ring"},
    {"linear_residuals": True}, {"gram_hessian": "on"}, {"verbose": True},
    {"matmul_precision": "default"},
])
def test_unported_option_raises(knob):
    with pytest.raises(NotImplementedError):
        SolverOptions(**knob)


@pytest.mark.parametrize("kw", [
    {"fuse": True}, {"bulk_compact": 2}, {"sort_by_difficulty": True},
    {"pipeline_overlap": True}, {"certify": "host"}, {"bulk_dtype": torch.bfloat16},
])
def test_unported_pipeline_knob_raises(kw):
    bp, th, X0 = exp_fit_family(2, d=8, seed=0)
    with pytest.raises(NotImplementedError):
        solve_mixed_precision(bp, th, X0, SolverOptions(), **kw)


def test_unported_routes_raise():
    bp, th, X0 = exp_fit_family(2, d=8, seed=0)
    with pytest.raises(NotImplementedError):
        polish_then_refine(bp, th, X0.float(), SolverOptions())    # all-f64 host polish
    with pytest.raises(NotImplementedError):
        resolve_operator_route(SolverOptions(), n=64, d_plus_p=256, dtype=torch.float32)
    assert resolve_operator_route(SolverOptions(), n=3, d_plus_p=32, dtype=torch.float32) == (False, "qr")
    assert resolve_operator_route(SolverOptions(), n=3, d_plus_p=32, dtype=torch.float64) == (False, "normal")


def test_interop_round_trip():
    # The JAX side hands its data over as numpy; the port rebuilds the same
    # problem and its SolveInfo comes back as numpy.
    from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit

    bp_j, th_j, X0_j = j_exp_fit(4, d=8, seed=1)
    bp = problem_from_numpy(
        np.asarray(bp_j.A), np.asarray(bp_j.b), np.asarray(bp_j.xl), np.asarray(bp_j.xu),
        bp_j.poly_batched, _exp_fit_residuals,
    )
    th = theta_from_numpy({k: np.asarray(v) for k, v in th_j.items()})
    bp_t, th_t, X0_t = exp_fit_family(4, d=8, seed=1)
    for f in ("A", "b", "xl", "xu"):
        assert torch.equal(getattr(bp, f), getattr(bp_t, f))
    assert torch.equal(th["y"], th_t["y"]) and bp.poly_batched
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched

    X, Y, info = solve_batched(bp, th, torch.as_tensor(np.array(X0_j)), SolverOptions(max_outer_iter=40))
    d = info_to_numpy(info)
    assert set(d) == set(type(info)._fields) and d["converged"].shape == (4,) and d["converged"].all()
