"""Package hygiene of the PyTorch port: it never imports jax (and
chip_smoke.py loads nothing of the JAX package), importing it exports the
public names and touches neither CUDA nor the kernel build, its options
table matches the JAX package's field by field, knobs whose route is not
ported raise instead of silently running another path (and the ported
operator knobs are accepted), its own copy of the KKT oracle gives the JAX
package's verdicts (point by point and over the classic battery), and the
interop helpers carry data across."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import benlsip_tpu
from benlsip_tpu.baselines import kkt_oracle as j_oracle
from benlsip_tpu_torch.baselines import kkt_oracle as t_oracle
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.interop import info_to_numpy, problem_from_numpy, theta_from_numpy
from benlsip_tpu_torch.problems.generators import exp_fit_family, _exp_fit_residuals
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.subproblem import resolve_operator_route

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "benlsip_tpu_torch",
    "benlsip_tpu_torch._device",
    "benlsip_tpu_torch._loops",
    "benlsip_tpu_torch._trace",
    "benlsip_tpu_torch.compat",
    "benlsip_tpu_torch.interop",
    "benlsip_tpu_torch.baselines.kkt_oracle",
    "benlsip_tpu_torch.baselines.numpy_ref",
    "benlsip_tpu_torch.kernels.batched_linalg",
    "benlsip_tpu_torch.ops.al",
    "benlsip_tpu_torch.ops.cholesky",
    "benlsip_tpu_torch.ops.constraints",
    "benlsip_tpu_torch.ops.native_qp",
    "benlsip_tpu_torch.ops.polyproject",
    "benlsip_tpu_torch.ops.project",
    "benlsip_tpu_torch.ops.qr",
    "benlsip_tpu_torch.solver.api",
    "benlsip_tpu_torch.solver.cg",
    "benlsip_tpu_torch.solver.inner",
    "benlsip_tpu_torch.solver.multipliers",
    "benlsip_tpu_torch.solver.options",
    "benlsip_tpu_torch.solver.outer",
    "benlsip_tpu_torch.solver.qp",
    "benlsip_tpu_torch.solver.status",
    "benlsip_tpu_torch.solver.subproblem",
    "benlsip_tpu_torch.solver.transforms",
    "benlsip_tpu_torch.batch.vmap_solve",
    "benlsip_tpu_torch.batch.polish",
    "benlsip_tpu_torch.batch.refine",
    "benlsip_tpu_torch.batch.fused_small",
    "benlsip_tpu_torch.batch.compact",
    "benlsip_tpu_torch.batch.buckets",
    "benlsip_tpu_torch.harness.logging",
    "benlsip_tpu_torch.harness.metrics",
    "benlsip_tpu_torch.harness.checkpoint",
    "benlsip_tpu_torch.harness.sweep",
    "benlsip_tpu_torch.harness.profile",
    "benlsip_tpu_torch.dist.collectives",
    "benlsip_tpu_torch.dist.mesh",
    "benlsip_tpu_torch.dist.sharded",
    "benlsip_tpu_torch.problems.classic",
    "benlsip_tpu_torch.problems.generators",
    "benlsip_tpu_torch.problems.hs48",
    "benlsip_tpu_torch.problems.rosenbrock",
    "benlsip_tpu_torch.problems.sphere_regression",
]
# The JAX package's `__all__` less what the port does not have: nothing.
NOT_PORTED_NAMES = set()


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


def test_every_port_module_is_listed():
    # A new module cannot escape the import check above.
    files = [p for p in (ROOT / "benlsip_tpu_torch").rglob("*.py") if p.name != "__init__.py"]
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in files} | {"benlsip_tpu_torch"}
    assert found - {"benlsip_tpu_torch._batched"} == set(PORT_MODULES)


def test_import_exports_public_names_without_cuda_or_kernel_build():
    import benlsip_tpu_torch as bt

    assert set(bt.__all__) == set(benlsip_tpu.__all__) - NOT_PORTED_NAMES
    assert all(hasattr(bt, name) for name in bt.__all__)
    code = (
        "import sys, torch\n"
        "from benlsip_tpu_torch import (Problem, solve, tralcnllss, least_squares, solve_qp,\n"
        "    with_inequalities, SolveInfo, SolverOptions)\n"
        "from benlsip_tpu_torch.kernels import batched_linalg as kern\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'triton' not in sys.modules\n"
        "assert kern.load_library.cache_info().currsize == 0, 'importing the package must not load the kernels'\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    build_dir = ROOT / "benlsip_tpu_torch" / "kernels" / "_build"
    before = sorted(build_dir.iterdir()) if build_dir.exists() else None
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    assert (sorted(build_dir.iterdir()) if build_dir.exists() else None) == before


def test_chip_smoke_names_no_file_of_the_jax_package():
    # The only mentions of `benlsip_tpu/` in chip_smoke.py are the
    # file:line strings of the TPU kernels its records say they replace;
    # it imports by name and loads nothing by path.
    src = (ROOT / "chip_smoke.py").read_text()
    mentions = re.findall(r"benlsip_tpu/[\w/.:-]*", src)
    assert mentions and all(re.fullmatch(r"benlsip_tpu/kernels/batched_linalg\.py:\d+", m) for m in mentions), mentions
    assert "importlib" not in src and "spec_from_file_location" not in src
    imported = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, flags=re.M)
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "benlsip_tpu")]
    assert "benlsip_tpu_torch.baselines.kkt_oracle" in imported


def _oracle_point(seed, kind):
    """A small bound- and equality-constrained linear least-squares point:
    `kind` picks a KKT point, a perturbed one, an infeasible one, or the
    fully-active box."""
    rng = np.random.default_rng(seed)
    n, d, m = 5, 9, 2
    J = rng.standard_normal((d, n))
    A = rng.standard_normal((m, n))
    x = rng.standard_normal(n)
    xl, xu = x - 1.0, x + 1.0
    on_lo = np.zeros(n, bool)
    on_lo[0] = True
    if kind == "all_active":
        xl, xu = x.copy(), x + 1.0
        on_lo[:] = True
    else:
        xl[0] = x[0]
    b = A @ x
    # Choose y so that x is stationary: Jᵀ(Jx − y) + Aᵀν − σ_lo = 0 with σ_lo ≥ 0.
    nu = rng.standard_normal(m)
    sigma = np.where(on_lo, rng.uniform(0.5, 1.0, n), 0.0)
    g = sigma - A.T @ nu
    r0 = np.linalg.lstsq(J.T, g, rcond=None)[0]      # Jᵀ r0 = g (d > n)
    y = J @ x - r0
    if kind == "perturbed":
        x = x + np.where(on_lo, 0.0, 1e-3)
        b = A @ x
    if kind == "infeasible":
        b = b + 1e-3
    if kind == "wrong_sign":
        xu[0], xl[0] = x[0], x[0] - 1.0               # the active bound is now the upper one
    return x, J @ x - y, J, None, None, A, b, xl, xu


@pytest.mark.parametrize("kind,ok", [
    ("kkt", True), ("perturbed", False), ("infeasible", False), ("wrong_sign", False), ("all_active", True),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_oracle_matches_jax_package_oracle(seed, kind, ok):
    args = _oracle_point(seed, kind)
    want = j_oracle.kkt_check_point(*args)
    got = t_oracle.kkt_check_point(*args)
    assert got == want and got["ok"] is ok
    assert got.get("degenerate_all_active", False) == (kind == "all_active")


def test_port_battery_oracle_matches_jax_package_on_three_entries(monkeypatch):
    # One entry with a nonlinear constraint, one with linear equalities and
    # a box, one unconstrained: the same verdicts from both packages.
    from benlsip_tpu.problems import classic as j_classic
    from benlsip_tpu_torch.problems import classic as t_classic

    names = ["hs42", "hs53", "mgh05_beale"]
    monkeypatch.setattr(j_classic, "REGISTRY", {k: j_classic.REGISTRY[k] for k in names})
    monkeypatch.setattr(t_classic, "REGISTRY", {k: t_classic.REGISTRY[k] for k in names})
    want = j_oracle.kkt_check_classic_battery()
    got = t_oracle.kkt_check_classic_battery(device="cpu")
    details = got.pop("battery_details")
    assert got == want == {"battery_oracle_checked": 3, "battery_oracle_agree": 3, "battery_oracle_fail": []}
    assert sorted(details) == sorted(names)
    for name, d in details.items():
        assert d["converged"] and d["verdict"]["ok"] and d["outer_iters"] >= 1 and d["seconds"] > 0
        assert d["verdict"]["n_eq"] == {"hs42": 2, "hs53": 3, "mgh05_beale": 0}[name]
    # A point that is not a KKT point fails the port's check of a Problem.
    rec = t_classic.REGISTRY["hs42"]
    bad = t_oracle.kkt_check_problem_point(rec.make_problem(), rec.x0(device="cpu"))
    assert bad["ok"] is False


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
    {"verbose": True}, {"verbose": 1},
])
def test_unported_option_raises(knob):
    # verbose is ported for eager loops; the fused route runs its loops as
    # CUDA-graph WHILE nodes, which cannot write on the host, so it refuses
    # the option up front (on the CPU too) instead of dropping the rows.
    opts = SolverOptions(**knob)
    bp, th, X0 = exp_fit_family(2, d=8, seed=0, device="cpu")
    with pytest.raises(ValueError):
        solve_mixed_precision(bp, th, X0, opts, fuse=True)


@pytest.mark.parametrize("knob", [
    {"linear_residuals": True}, {"gram_hessian": "on"}, {"gram_hessian": "off"},
    {"gn_factorization": "cholqr2"},
    {"spmd_axis": "x"}, {"gram_layout": "sharded"}, {"reduce_schedule": "ring"},
    {"matmul_precision": "default"},
])
def test_ported_operator_option_accepted(knob):
    assert getattr(SolverOptions(**knob), next(iter(knob))) == next(iter(knob.values()))


@pytest.mark.parametrize("kw", [
    {"fuse": True, "bulk_compact": 2}, {"fuse": True, "sort_by_difficulty": True},
    {"fuse": True, "pipeline_overlap": True}, {"fuse": True, "bulk_dtype": torch.bfloat16},
    {"pipeline_overlap": True, "bulk_dtype": torch.bfloat16},
])
def test_unported_pipeline_knob_raises(kw):
    # fuse=True with a scheduling route, and fuse=True or pipeline_overlap
    # with a bf16 bulk, would drop the other knob silently (the JAX
    # pipeline does), so the port refuses.
    bp, th, X0 = exp_fit_family(2, d=8, seed=0, device="cpu")
    with pytest.raises(ValueError):
        solve_mixed_precision(bp, th, X0, SolverOptions(), **kw)


def test_unported_routes_raise():
    # A bf16 qr_r takes the kernel's gate (its plain version on the CPU);
    # every replicated operator route resolves.
    from benlsip_tpu_torch.kernels import batched_linalg as kern
    from benlsip_tpu_torch.ops.qr import qr_r

    S = torch.ones(2, 8, 3, dtype=torch.bfloat16)
    assert torch.equal(qr_r(S), kern.batched_thin_qr_plain(S)[1]) and qr_r(S).dtype == torch.bfloat16
    assert resolve_operator_route(SolverOptions(), n=64, d_plus_p=256, dtype=torch.float32) == (True, "cholqr2")
    assert resolve_operator_route(SolverOptions(), n=64, d_plus_p=256, dtype=torch.float64) == (True, "normal")
    assert resolve_operator_route(SolverOptions(), n=3, d_plus_p=32, dtype=torch.float32) == (False, "qr")
    assert resolve_operator_route(SolverOptions(), n=3, d_plus_p=32, dtype=torch.float64) == (False, "normal")


def test_interop_round_trip():
    # The JAX side hands its data over as numpy; the port rebuilds the same
    # problem and its SolveInfo comes back as numpy.
    from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit

    bp_j, th_j, X0_j = j_exp_fit(4, d=8, seed=1)
    bp = problem_from_numpy(
        np.asarray(bp_j.A), np.asarray(bp_j.b), np.asarray(bp_j.xl), np.asarray(bp_j.xu),
        bp_j.poly_batched, _exp_fit_residuals, device="cpu",
    )
    th = theta_from_numpy({k: np.asarray(v) for k, v in th_j.items()}, device="cpu")
    bp_t, th_t, X0_t = exp_fit_family(4, d=8, seed=1, device="cpu")
    for f in ("A", "b", "xl", "xu"):
        assert torch.equal(getattr(bp, f), getattr(bp_t, f))
    assert torch.equal(th["y"], th_t["y"]) and bp.poly_batched
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched

    X, Y, info = solve_batched(bp, th, torch.as_tensor(np.array(X0_j)), SolverOptions(max_outer_iter=40))
    d = info_to_numpy(info)
    assert set(d) == set(type(info)._fields) and d["converged"].shape == (4,) and d["converged"].all()
