"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 is off;
2. build the CUDA kernels of benlsip_tpu_torch from csrc/ (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, in float32,
   at the main path's shapes and the kernel tests' shapes, with the NaN,
   positive-diagonal and empty-batch checks, and the warm time of both;
4. the main path: `solve_mixed_precision` on config 2
   (`exp_fit_family(1024, d=32, seed=42)`, float64 master data) on cuda:0,
   with every kernel's launch count read around that run; 1024/1024 must
   certify at max(pix) ≤ sqrt(eps(f64)) ≈ 1.49e-8, the independent numpy
   KKT oracle must agree on 128 sampled instances, and a small batch must
   agree with the port's CPU run (the plain versions);
5. with `--profile` only: the warm wall split into bulk and certification,
   and the device's busy share and kernel count from torch.profiler.

It imports nothing of JAX: the oracle module is loaded by file path.
The last two lines are the kernels' JSON record and the result JSON.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ORACLE_PATH = ROOT / "benlsip_tpu" / "baselines" / "kkt_oracle.py"

# Kernel vs plain version in float32.  Cholesky and the solve run the same
# operations in the same order with every product and sum separately
# rounded on both sides, so they should agree to the last bit; QR sums its
# dot products in another order (warp shuffles vs torch's reduction), a
# float32 rounding difference of O(sqrt(D)·eps).
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
CERT_PIX = math.sqrt(np.finfo(np.float64).eps)   # 1.49e-8: f64 KKT grade
SMALL_ATOL = 1e-7                                # card vs CPU run of the port


def _sync():
    torch.cuda.synchronize()


def _cuda_ms(fn, reps: int = 200, warm: int = 10) -> float:
    """Warm per-call time of fn on the card (CUDA events over `reps` calls)."""
    for _ in range(warm):
        fn()
    _sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _check_close(name: str, got: torch.Tensor, want: torch.Tensor, atol: float = KERNEL_ATOL) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err:.3e})")
    return err


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU machine only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


def phase_build(kern) -> float:
    t0 = time.perf_counter()
    lib_path = kern.build()
    kern.load_library()
    dt = time.perf_counter() - t0
    print(f"build: {lib_path.name} in {dt:.2f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        fn = "?"
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill" in line and ("0 bytes spill stores" not in line or "0 bytes spill loads" not in line):
                print(f"ptxas: {fn}: {line.strip()}")
    return dt


def phase_kernels(kern) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel records."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    f32 = torch.float32

    def spd(B, M):
        A = rng.standard_normal((B, M, M))
        K = A @ np.transpose(A, (0, 2, 1)) + M * np.eye(M)
        return torch.as_tensor(K, dtype=f32, device=dev)

    rec = {k: {"max_abs_err": 0.0} for k in ("batched_cholesky", "batched_cho_solve", "batched_thin_qr")}

    for M in (1, 2, 3, 5, 8, 16):
        K = spd(1024, M)
        L = kern.batched_cholesky(K)
        rec["batched_cholesky"]["max_abs_err"] = max(
            rec["batched_cholesky"]["max_abs_err"],
            _check_close(f"cholesky M={M}", L, kern.batched_cholesky_plain(K)),
        )
        b = torch.as_tensor(rng.standard_normal((1024, M)), dtype=f32, device=dev)
        x = kern.batched_cho_solve(L, b)
        xp = kern.batched_cho_solve_plain(L, b)
        rec["batched_cho_solve"]["max_abs_err"] = max(
            rec["batched_cho_solve"]["max_abs_err"],
            _check_close(f"cho_solve M={M}", x, xp, atol=KERNEL_ATOL * float(xp.abs().max())),
        )
    # NaN on a non-SPD pivot, no clamping; other instances stay finite.
    K = spd(1024, 3)
    K[5, 2, 2] = -50.0
    L = kern.batched_cholesky(K)
    if not (torch.isnan(L[5, 2, 2]) and torch.isfinite(L[torch.arange(1024, device=dev) != 5]).all()):
        raise AssertionError("cholesky: a non-SPD pivot must give NaN in its own instance only")
    if not torch.equal(torch.isnan(L), torch.isnan(kern.batched_cholesky_plain(K))):
        raise AssertionError("cholesky: NaN pattern differs from the plain version")

    for B, D, N in ((1024, 35, 3), (1024, 3, 1), (200, 32, 3), (140, 16, 8)):
        A = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=f32, device=dev)
        Q, R = kern.batched_thin_qr(A)
        Qp, Rp = kern.batched_thin_qr_plain(A)
        err = max(
            _check_close(f"qr Q {B}x{D}x{N}", Q, Qp),
            _check_close(f"qr R {B}x{D}x{N}", R, Rp, atol=KERNEL_ATOL * math.sqrt(D)),
        )
        rec["batched_thin_qr"]["max_abs_err"] = max(rec["batched_thin_qr"]["max_abs_err"], err)
        if not (torch.diagonal(R, dim1=1, dim2=2) > 0).all() or torch.tril(R, -1).abs().max() != 0:
            raise AssertionError("qr: R must be upper triangular with a positive diagonal")
        if not torch.allclose(Q @ R, A, rtol=1e-4, atol=1e-4):
            raise AssertionError("qr: Q R does not reproduce A")

    # Empty batches: no launch, JAX-shaped outputs.
    before = dict(kern.LAUNCHES)
    Q, R = kern.batched_thin_qr(torch.zeros((0, 35, 3), device=dev))
    shapes = (
        kern.batched_cholesky(torch.zeros((0, 3, 3), device=dev)).shape,
        kern.batched_cho_solve(torch.zeros((4, 0, 0), device=dev), torch.zeros((4, 0), device=dev)).shape,
        Q.shape, R.shape,
    )
    if shapes != ((0, 3, 3), (4, 0), (0, 35, 3), (0, 3, 3)) or kern.LAUNCHES != before:
        raise AssertionError(f"empty batches: shapes {shapes}, launches {kern.LAUNCHES} vs {before}")
    # A non-contiguous tensor is refused, not silently copied.
    try:
        kern.batched_cholesky(spd(8, 3).transpose(1, 2))
    except ValueError:
        pass
    else:
        raise AssertionError("cholesky: a non-contiguous input must raise")
    _sync()

    # Warm times at the main path's shapes: the bulk factors and solves at
    # the chunk width (512, M = m = 1), the certification's QR at B = 1024.
    K1 = spd(512, 1)
    L1 = kern.batched_cholesky(K1)
    b1 = torch.as_tensor(rng.standard_normal((512, 1)), dtype=f32, device=dev)
    S = torch.as_tensor(rng.standard_normal((1024, 35, 3)), dtype=f32, device=dev)
    W = torch.as_tensor(rng.standard_normal((1024, 3, 1)), dtype=f32, device=dev)
    timings = {
        "batched_cholesky": ("512x1x1", lambda: kern.batched_cholesky(K1), lambda: kern.batched_cholesky_plain(K1)),
        "batched_cho_solve": ("512x1x1", lambda: kern.batched_cho_solve(L1, b1), lambda: kern.batched_cho_solve_plain(L1, b1)),
        "batched_thin_qr": ("1024x35x3", lambda: kern.batched_thin_qr(S), lambda: kern.batched_thin_qr_plain(S)),
    }
    for name, (shape, k_fn, p_fn) in timings.items():
        rec[name]["ms"] = _cuda_ms(k_fn)
        rec[name]["plain_ms"] = _cuda_ms(p_fn)
        rec[name]["shape"] = shape
        print(f"{name} {shape}: kernel {rec[name]['ms']:.4f} ms, plain {rec[name]['plain_ms']:.4f} ms, "
              f"max abs err {rec[name]['max_abs_err']:.3e}")
    ms_w, pl_w = _cuda_ms(lambda: kern.batched_thin_qr(W)), _cuda_ms(lambda: kern.batched_thin_qr_plain(W))
    print(f"batched_thin_qr 1024x3x1: kernel {ms_w:.4f} ms, plain {pl_w:.4f} ms")
    return rec


def _load_oracle():
    spec = importlib.util.spec_from_file_location("kkt_oracle", ORACLE_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice(kern) -> dict:
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import exp_fit_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = torch.device("cuda:0")
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    B = 1024
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=torch.float64, device=dev)

    kern.reset_launches()
    _sync()
    t0 = time.perf_counter()
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts)
    _sync()
    cold = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    if not (torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False):
        raise AssertionError("TF32 must be off on the main path")

    t0 = time.perf_counter()
    X2, _, info2 = solve_mixed_precision(bp, theta, X0, opts)
    _sync()
    warm = time.perf_counter() - t0

    n_cert = int(info.converged.sum())
    pix_max = float(info.pix.max())
    print(f"slice: config 2, B={B}: certified {n_cert}/{B}, max pix {pix_max:.3e}, "
          f"cold {cold:.3f} s, warm {warm:.3f} s, launches {launches}")
    if X.shape != (B, 3) or X.dtype != torch.float64 or not torch.isfinite(X).all():
        raise AssertionError("slice: X must be finite float64 of shape (1024, 3)")
    if n_cert != B or pix_max > CERT_PIX:
        raise AssertionError(f"slice: {n_cert}/{B} certified, max pix {pix_max:.3e} (need {B} at ≤ {CERT_PIX:.3e})")
    if not torch.equal(info2.converged, info.converged) or float((X2 - X).abs().max()) > SMALL_ATOL:
        raise AssertionError("slice: the warm run disagrees with the cold run")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"slice: kernel {name} was not launched on the main path")

    # Independent first-principles KKT oracle on 128 sampled instances.
    oracle = _load_oracle()
    fns = bp.instance_fns(theta)
    r = fns.residuals(X).cpu().numpy()
    J = fns.jac_res(X).cpu().numpy()
    Xh = X.cpu().numpy()
    A = bp.A.cpu().numpy()
    b_rhs = bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    sample = np.random.default_rng(0).choice(B, size=128, replace=False)
    agree = sum(
        oracle.kkt_check_point(Xh[i], r[i], J[i], None, None, A, b_rhs[i], xl, xu)["ok"] for i in sample
    )
    print(f"oracle: {agree}/128 sampled instances pass the numpy KKT check")
    if agree != 128:
        raise AssertionError(f"oracle agrees on {agree}/128")

    # The card against the port's CPU run (plain versions) on a small batch.
    bp_s, th_s, X0_s = exp_fit_family(64, d=32, seed=42, dtype=torch.float64)
    Xc, _, ic = solve_mixed_precision(bp_s, th_s, X0_s, opts)
    bp_g, th_g, X0_g = exp_fit_family(64, d=32, seed=42, dtype=torch.float64, device=dev)
    Xg, _, ig = solve_mixed_precision(bp_g, th_g, X0_g, opts)
    diff = float((Xg.cpu() - Xc).abs().max())
    print(f"small batch (64): card vs CPU max |dX| {diff:.3e}, certified {int(ig.converged.sum())}/64 vs {int(ic.converged.sum())}/64")
    if not (bool(ig.converged.all()) and bool(ic.converged.all()) and diff <= SMALL_ATOL):
        raise AssertionError("small batch: the card's run disagrees with the CPU run")
    return {"launches": launches, "cold_s": cold, "warm_s": warm, "certified": n_cert, "pix_max": pix_max}


def phase_profile() -> None:
    """Where the warm main-path time goes: bulk vs certification wall, and
    the device's busy share from torch.profiler (sum of kernel times over
    the host wall of one warm run)."""
    from torch.profiler import ProfilerActivity, profile

    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.problems.generators import exp_fit_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = torch.device("cuda:0")
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(1024, d=32, seed=42, dtype=torch.float64, device=dev)
    bulk_opts = SolverOptions(max_outer_iter=40, max_inner_iter=8, crit_tol=1e-2)
    bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(theta, torch.float32)
    walls = {}
    for name, fn in (
        ("bulk", lambda: solve_batched_chunked(bp32, th32, X0.float(), bulk_opts, chunk=512)),
        ("pipeline", lambda: solve_mixed_precision(bp, theta, X0, opts)),
    ):
        fn()
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        walls[name] = time.perf_counter() - t0
    print(f"profile: warm wall bulk {walls['bulk']:.3f} s, certification {walls['pipeline'] - walls['bulk']:.3f} s, "
          f"pipeline {walls['pipeline']:.3f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_mixed_precision(bp, theta, X0, opts)
        _sync()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    n_launch = sum(e.count for e in events)
    print(f"profile: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s ({100 * dev_us / 1e6 / wall:.1f}%), "
          f"{n_launch} device kernels")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"profile: {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<7d} {e.key[:90]}")


def main() -> None:
    smi = phase_card()   # raises without a CUDA device, before any output
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    print(f"card: {smi}")
    phase_build(kern)
    rec = phase_kernels(kern)
    res = phase_slice(kern)
    if "--profile" in sys.argv[1:]:
        phase_profile()
    sources = {
        "batched_cholesky": ("benlsip_tpu_torch/kernels/csrc/cholesky.cu", "benlsip_tpu/kernels/batched_linalg.py:74"),
        "batched_cho_solve": ("benlsip_tpu_torch/kernels/csrc/cho_solve.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "batched_thin_qr": ("benlsip_tpu_torch/kernels/csrc/thin_qr.cu", "benlsip_tpu/kernels/batched_linalg.py:170"),
    }
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": res["launches"][name], "max_abs_err": rec[name]["max_abs_err"],
            "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        }
        for name, (src, rep) in sources.items()
    ]
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
