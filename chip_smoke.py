"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 is off;
2. build the CUDA kernels of benlsip_tpu_torch from csrc/ (nvcc, sm_90a);
3. each of the six kernels against its plain PyTorch version on the card,
   in float32, at every path's shapes (batches of one included, config
   5's polish QR at 16,384 instances) and the
   kernel tests' shapes, with
   the NaN, positive-diagonal, empty-batch and refused-operand checks; the
   two fused kernels also with a batch-shared (stride-0) A, ragged n,
   degenerate lanes and reg > 0, and against the call site they replace;
   the panel QR kernel also against `torch.linalg.qr` and SᵀS, at the
   polish's shape, ragged panels, every panel width, κ = 1e4 and float64;
   then, taken in turns inside this one process (plain, kernel, library,
   library, kernel, plain; CUDA events over 200 calls, 20 for the panel
   QR), the time of every kernel, of its plain version and of the one
   PyTorch call that computes the same function (for a fused kernel: of the
   call site it replaces, with the old kernel inside), beside the bound
   computed from the shapes;
4. the config-2 path: `solve_mixed_precision` on
   `exp_fit_family(1024, d=32, seed=42)` (float64 master data) on cuda:0,
   with every kernel's launch count read around that run; 1024/1024 must
   certify at max(pix) ≤ sqrt(eps(f64)) ≈ 1.49e-8, the independent numpy
   KKT oracle must agree on 128 sampled instances, and a small batch must
   agree with the port's CPU run (the plain versions);
4b. the fused config-2 path: each of the four path kernels captured
   alone into a CUDA graph and replayed equals its eager call; then
   `solve_mixed_precision(..., fuse=True)` (`batch/fused_small.py`: the
   bulk of a chunk and the certification as CUDA graphs whose loops are
   conditional WHILE nodes) on the same family, cold and warm: 1024/1024
   certified at ≤ 1.49e-8, the oracle on 128, within rtol 1e-6 / atol 1e-8
   of the unfused run and of the same stages run eagerly, every path
   kernel captured and run by the replays (counted exactly: a WHILE body's
   captured launches times the trips its loop ran, at least what the same
   stages launch eagerly), no kernel launched outside the graphs in a warm
   call; host syncs per warm call fused beside unfused, the replays'
   device kernels, capture and instantiate seconds, and 5 warm walls of
   each taken in turns;
5. the config-3 path: `solve_mixed_precision` on
   `dense_quadratic_family(64, n=192, d=1024, m=6, seed=3)` on cuda:0 (the
   materialized CholeskyQR2 operator in the bulk, the fused
   certification), launch counts and the solver's operator builds read
   around the cold run (every float32 build must be CholeskyQR2); 64/64 must
   certify at max(pix) ≤ 1.49e-8 cold and warm, `certify="host"` (f64
   chord phase on the CPU) must certify 64/64 too, the panel QR kernel
   must be launched in both certify modes, the oracle must agree
   on all 64, and a batch of 8 must agree with the port's CPU run; the warm
   wall is split into bulk and certification;
6. the config-1 path, through the public entry points: `solve` and
   `tralcnllss` on the sphere-regression fixture in float64 on the card
   (analytic and autodiff Jacobians, a warm start from y) against the
   known optimum, the KKT oracle and the port's CPU run; the same fixture
   and a bound-only problem in float32 at B = 1, where the kernels run on
   grids of one block and a problem without equalities launches no factor
   or projection kernel; the 18 classic HS/MGH problems, each converged,
   feasible, at its published optimum and passed by the oracle;
   `solve_mixed_precision` on `sphere_family(1024, seed=0)` (one nonlinear
   constraint per instance) in both certify modes and with fuse=True (walls
   side by side), at least 90% certified
   at pix, feas ≤ 1.49e-8, oracle on 128 certified lanes with (c, C), the
   first 64 instances against the port's CPU run; `solve_qp`,
   `with_inequalities` and `least_squares` once each against a dense KKT
   solve, the published optimum and scipy;
7. the config-4 path (one large instance): `solve_large_blocked_family` on
   `blocked_hard_family(n=10240, d=20480, m=8, seed=0)` in float32 on a
   one-rank NCCL mesh (`make_mesh(1, 1)`), one cold and two warm calls; it
   must converge, pass the numpy KKT oracle at f32 grade (5e-4), build the
   Gram operator in float32 only and launch the factor, projection and
   solve kernels (checked and timed against their plain versions at
   (1, 8, 10240) and (1, 8) in phase 3); then the explicit-collective path
   (`solve_large_blocked_shardmap`, every operator layout and reduce
   schedule) on the same group against the plain solve at n=2048,
   d=8192, and the card against the port's CPU run at n=1024 in float32
   and float64;
8. the config-5 path (BASELINE config 5, the 100k-instance sweep):
   (a) `solve_mixed_precision` on `exp_fit_family(16384, d=32, seed=7)`
   (float64 master data) on cuda:0 through the plain route (cold, launch
   counts read around it), converged-instance compaction
   (`bulk_compact=2`) and `fuse=True` (cold and warm): 16384/16384
   certified at ≤ 1.49e-8 on each, compaction's X identical to the plain
   route's, the fused route within rtol 1e-6 / atol 1e-8 of it, the oracle
   on 256 sampled instances, the path kernels launched (and captured and
   run by the fused replays); the survivors of stage A, host syncs per warm
   call, warm walls in turns (5 each, fewer if the phase's 300 s budget
   says so, and then it says so) and certified instances per second,
   beside the numpy baseline (`solve_exp_fit_numpy`) on the first 64
   instances; (b) `sort_by_difficulty` and `pipeline_overlap` in both
   certify modes once each (at B = 4096 where (a) and (b) at 16,384
   would pass the budget, and then it says so): every lane certified, X
   within 1e-8 of the plain route, each wall beside the plain one and
   the overlap's beside the sum of its stages; (c) `run_sweep` of
   `exp_fit_family(102400)` in sweep chunks of 16,384 through
   `fuse=True`, checkpointed into a temporary directory, then the same
   sweep stopped after 2 chunks and resumed: 102,400 certified, the
   resumed result bitwise equal to the uninterrupted one, resumed from
   chunk 2; wall, rate and checkpoint bytes per step;
9. with `--profile` only: each path's warm wall split into bulk and
   certification, how many lanes the fused polish certifies alone and with
   its re-polish buckets, and the device's busy share and kernel count from
   torch.profiler, with the time and calls of cuSOLVER's `geqr2*` and of
   the panel QR kernel; the fused config-2 path's device span (CUDA
   events), its device kernels (exact, from the graphs) and its busy share
   (the device time of the same stages traced eagerly, over the fused
   wall) beside the unfused path's; for config 4 one traced warm run,
   the busy share and the largest device kernels by name (the Gram GEMM
   first); for config 5 the same split, and the compacted bulk's wall
   and one traced compacted run.

It imports nothing of JAX and nothing of the JAX package: the KKT oracle
is the port's own copy.  The last two lines are the kernels' JSON record
(launch counts per path, times, bounds) and the result JSON.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import numpy as np
import torch

# Kernel vs plain version in float32.  Cholesky and the solve run the same
# operations in the same order with every product and sum separately
# rounded on both sides, so they should agree to the last bit; QR sums its
# dot products in another order (warp shuffles vs torch's reduction), a
# float32 rounding difference of O(sqrt(D)·eps).
# The fused kernels sum their dot products over n by warp shuffles too, so
# their atol scales with sqrt(n) times the largest row norm of A (factor) or
# with sqrt(n)·max|r| (projection); NaN patterns must be equal exactly.
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
CERT_PIX = math.sqrt(np.finfo(np.float64).eps)   # 1.49e-8: f64 KKT grade
SMALL_ATOL = 1e-7                                # card vs CPU run of the port

# Published peaks of the H100 SXM, for the bounds: device memory rate and
# the float32 rate outside the tensor cores (no kernel here uses them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# The kernels on each path; `batched_cholesky` runs there inside
# `masked_aat_cholesky`, which holds its body.  Config 3 (n = 192) also
# runs the panel QR kernel; config 2 (n = 3) has no wide QR.
PATH_KERNELS = ("masked_aat_cholesky", "project_tangent", "batched_cho_solve", "batched_thin_qr")
# Their CUDA function names, as a profiler trace shows them.
DEVICE_NAMES = {"masked_aat_cholesky": "masked_aat_cholesky_kernel", "project_tangent": "project_tangent_kernel",
                "batched_cho_solve": "cho_solve_kernel", "batched_thin_qr": "mgs_qr_kernel"}
CONFIG3_KERNELS = PATH_KERNELS + ("blocked_qr_r",)
# Device kernels of one warm run before the panel QR kernel (H100 80GB HBM3, 700 W).
DEVICE_KERNELS_BEFORE = {"config 2": "68,888-68,892", "config 3": "17,405-17,413"}
# The sphere-regression fixture's optimum (float64 solves of both packages agree on these digits).
SPHERE_X_STAR = (1.37471722, 0.08763489, 1.04998699)
EPS32 = float(np.finfo(np.float32).eps)


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


def _in_turns(fns: dict, reps: int = 200, warm: int = 10) -> dict:
    """Warm per-call time of each function, taken in turns (first to last,
    then last to first) inside this process; the mean of the two."""
    order = list(fns)
    total = dict.fromkeys(order, 0.0)
    for name in order + order[::-1]:
        total[name] += _cuda_ms(fns[name], reps, warm)
    return {name: t / 2 for name, t in total.items()}


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    ms = max(t_bytes, t_ops) * 1e3
    return {"bound_ms": ms, "bound_us": ms * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "flops": int(flops)}


def _qr_bound(B: int, D: int, N: int) -> dict:
    """Thin QR of (B, D, N): A read, Q and R written; 2·D·N² operations."""
    return _bound(B * (2 * D * N + N * N) * 4, 2 * B * D * N * N)


def _r_bound(B: int, D: int, N: int, itemsize: int = 4) -> dict:
    """R factor of (B, D, N): S read, R written; 2·D·N² − ⅔·N³ operations."""
    return _bound(B * (D * N + N * N) * itemsize, B * (2 * D * N * N - 2 * N ** 3 / 3))


def _check_same_nan(name: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """NaN patterns equal exactly; the rest close."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN pattern differs from the plain version's")
    ok = ~torch.isnan(want)
    return _check_close(name, got[ok], want[ok], atol=atol)


def old_factor_site(kern, A, fixed, reg=0.0):
    """`factor_masked_aat` as it ran before the fused kernel: mask, cast,
    multiply, bmm, jitter, the Cholesky kernel."""
    free = ~fixed
    K = (A * free.to(A.dtype).unsqueeze(-2)) @ A.mT
    if reg:
        K = K + reg * torch.eye(A.shape[-2], dtype=A.dtype, device=A.device)
    return kern.batched_cholesky(K.contiguous())


def old_project_site(kern, A, L, fixed, r):
    """`project_tangent` as it ran before the fused kernel: mask, bmm, the
    solve kernel, bmm, mask, subtract."""
    free = ~fixed
    rz = torch.where(free, r, 0.0)
    w = kern.batched_cho_solve(L.contiguous(), (A @ rz.unsqueeze(-1)).squeeze(-1).contiguous())
    return rz - torch.where(free, (A.mT @ w.unsqueeze(-1)).squeeze(-1), 0.0)


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
        # ptxas report: the most registers of any instantiation of each
        # kernel, those of the float32 instantiations the two paths run
        # (M = 1 and M = 6; the panel QR at width 32), and every
        # instantiation that spills.
        regs, on_path, entry = {}, {}, "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                family = next((k for k in ("masked_aat_cholesky", "project_tangent", "cholesky", "cho_solve", "mgs_qr",
                                           "blocked_qr_r") if k in entry), entry)
                used = int(line.split("Used")[1].split("registers")[0])
                regs[family] = max(regs.get(family, 0), used)
                if family == "blocked_qr_r":   # config 3 runs the float32 kernel at panel width 32
                    if "IfLi32E" in entry:
                        on_path[f"{family} width=32"] = used
                    continue
                for M in (1, 6):
                    if f"IfLi{M}E" in entry:
                        on_path[f"{family} M={M}"] = max(on_path.get(f"{family} M={M}", 0), used)
            elif "spill" in line and ("0 bytes spill stores" not in line or "0 bytes spill loads" not in line):
                print(f"ptxas: {entry}: {line.strip()}")
        print(f"ptxas: most registers per thread by kernel: {regs}")
        print(f"ptxas: registers per thread of the float32 instantiations on the paths: {on_path}")
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

    rec = {k: {"max_abs_err": 0.0} for k in kern.LAUNCHES}

    def worst(name, err):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    for B, M in ((1024, 1), (1024, 2), (1024, 3), (1024, 5), (64, 6), (1024, 8), (1024, 16), (1, 1), (1, 2), (1, 3), (1, 6), (1, 8), (1, 16)):
        K = spd(B, M)
        L = kern.batched_cholesky(K)
        worst("batched_cholesky", _check_close(f"cholesky {B}x{M}x{M}", L, kern.batched_cholesky_plain(K)))
        b = torch.as_tensor(rng.standard_normal((B, M)), dtype=f32, device=dev)
        x = kern.batched_cho_solve(L, b)
        xp = kern.batched_cho_solve_plain(L, b)
        worst("batched_cho_solve", _check_close(f"cho_solve {B}x{M}", x, xp, atol=KERNEL_ATOL * float(xp.abs().max())))
    # NaN on a non-SPD pivot, no clamping; other instances stay finite.
    K = spd(1024, 3)
    K[5, 2, 2] = -50.0
    L = kern.batched_cholesky(K)
    if not (torch.isnan(L[5, 2, 2]) and torch.isfinite(L[torch.arange(1024, device=dev) != 5]).all()):
        raise AssertionError("cholesky: a non-SPD pivot must give NaN in its own instance only")
    if not torch.equal(torch.isnan(L), torch.isnan(kern.batched_cholesky_plain(K))):
        raise AssertionError("cholesky: NaN pattern differs from the plain version")

    for B, D, N in ((1024, 35, 3), (1024, 3, 1), (16384, 35, 3), (16384, 3, 1), (64, 192, 6), (200, 32, 3), (140, 16, 8),
                    (1024, 3, 2), (1024, 7, 3), (1, 3, 1), (1, 3, 2), (1, 7, 3), (1, 35, 3), (1, 192, 6)):
        A = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=f32, device=dev)
        Q, R = kern.batched_thin_qr(A)
        Qp, Rp = kern.batched_thin_qr_plain(A)
        worst("batched_thin_qr", max(
            _check_close(f"qr Q {B}x{D}x{N}", Q, Qp),
            _check_close(f"qr R {B}x{D}x{N}", R, Rp, atol=KERNEL_ATOL * math.sqrt(D)),
        ))
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

    _check_fused(kern, rng, worst)
    _sync()
    _check_blocked_qr(kern, rng, worst)
    _sync()
    for name in rec:
        print(f"{name}: max abs err {rec[name]['max_abs_err']:.3e} over every checked shape")
    _time_kernels(kern, rng, rec)
    return rec


def _fused_case(rng, B, m, n, shared, dev):
    """Operands of the fused kernels: A (a stride-0 expand of one matrix
    when shared), a mask whose first min(n - 1, 4m) columns stay free (a
    well-conditioned A Z Aᵀ), r, and two degenerate lanes: the last is all
    fixed, the one before has one free column under m equalities and
    entries of A in {±1, ±2}, so that its sums are exact in any order and
    its NaN pattern does not hang on rounding."""
    ints = lambda shape: rng.choice([-2.0, -1.0, 1.0, 2.0], shape)
    if shared:
        A = torch.as_tensor(ints((m, n)), dtype=torch.float32, device=dev).expand(B, m, n)
    else:
        A_np = rng.standard_normal((B, m, n))
        A_np[B - 2] = ints((m, n))
        A = torch.as_tensor(A_np, dtype=torch.float32, device=dev)
    fixed = rng.random((B, n)) < 0.3
    fixed[:, : min(n - 1, 4 * m)] = False
    fixed[B - 2] = True
    fixed[B - 2, 1] = False
    fixed[B - 1] = True
    r = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=dev)
    return A, torch.as_tensor(fixed, device=dev), r


def _check_fused(kern, rng, worst) -> None:
    """The two fused kernels against their plain versions and against the
    call sites they replace."""
    dev = torch.device("cuda:0")
    cases = [(512, 1, 3, False), (64, 6, 192, True), (64, 6, 192, False)]
    cases += [(130, m, n, shared) for m in (2, 3, 5, 8, 16) for n, shared in ((37, False), (200, True))]
    cases += [(130, 3, 5000, False)]   # n has no cap: the lanes stride over it
    # One instance, as a single solve launches them: a regular lane (B = 1)
    # and the degenerate pair alone (B = 2).
    single = [(1, 2, 5), (1, 1, 3), (1, 3, 4), (1, 1, 2), (1, 6, 192), (1, 8, 10240), (2, 2, 5)]
    for B, m, n, shared in cases + [(B, m, n, False) for B, m, n in single]:
        if (B, m, n) in single:
            A, fixed, r = (t[:1].contiguous() if B == 1 else t[1:].contiguous() for t in _fused_case(rng, 3, m, n, False, dev))
            tag = f"{B}x{m}x{n}"
            for reg in (0.0, 1e-3):
                L, Lp = kern.masked_aat_cholesky(A, fixed, reg), kern.masked_aat_cholesky_plain(A, fixed, reg)
                atol = KERNEL_ATOL * math.sqrt(n) * float(torch.linalg.vector_norm(A, dim=-1).max())
                worst("masked_aat_cholesky", _check_same_nan(f"masked_aat_cholesky {tag} reg={reg}", L, Lp, atol))
            for unmasked in (False, True):   # L of reg = 1e-3: finite in every lane
                P = kern.project_tangent(A, L, fixed, r, unmasked_output=unmasked)
                Pp = kern.project_tangent_plain(A, L, fixed, r, unmasked_output=unmasked)
                atol = KERNEL_ATOL * math.sqrt(n) * float(r.abs().max())
                worst("project_tangent", _check_same_nan(f"project_tangent {tag} unmasked={unmasked}", P, Pp, atol))
            if B == 1 and not (torch.isfinite(kern.masked_aat_cholesky(A, fixed)).all() and torch.isfinite(P).all()):
                raise AssertionError(f"fused kernels {tag}: a regular single instance must stay finite")
            continue
        A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        if shared and A.stride(0) != 0:
            raise AssertionError("the shared A must reach the kernels as a stride-0 view")
        tag = f"{B}x{m}x{n}{' shared' if shared else ''}"
        row = float(torch.linalg.vector_norm(A, dim=-1).max())
        for reg in (0.0, 1e-3):
            L = kern.masked_aat_cholesky(A, fixed, reg)
            Lp = kern.masked_aat_cholesky_plain(A, fixed, reg)
            atol = KERNEL_ATOL * math.sqrt(n) * row
            worst("masked_aat_cholesky", _check_same_nan(f"masked_aat_cholesky {tag} reg={reg}", L, Lp, atol))
            _check_same_nan(f"masked_aat_cholesky {tag} vs its old call site", L, old_factor_site(kern, A, fixed, reg), atol)
            if torch.triu(L, 1).abs().max() != 0:
                raise AssertionError(f"masked_aat_cholesky {tag}: entries above the diagonal must be zero")
        # reg = 0 from here on: the last two lanes are degenerate.
        L = kern.masked_aat_cholesky(A, fixed)
        if m >= 3 and not (torch.isnan(L[B - 2, 2, 1]) and torch.isnan(L[B - 1, 1, 0]) and torch.isfinite(L[: B - 2]).all()):
            raise AssertionError(f"masked_aat_cholesky {tag}: NaN must stay in the degenerate lanes")
        atol = KERNEL_ATOL * math.sqrt(n) * float(r.abs().max())
        for unmasked in (False, True):
            P = kern.project_tangent(A, L, fixed, r, unmasked_output=unmasked)
            Pp = kern.project_tangent_plain(A, L, fixed, r, unmasked_output=unmasked)
            worst("project_tangent", _check_same_nan(f"project_tangent {tag} unmasked={unmasked}", P, Pp, atol))
        P = kern.project_tangent(A, L, fixed, r)
        _check_same_nan(f"project_tangent {tag} vs its old call site", P, old_project_site(kern, A, L, fixed, r), atol)
        if P[fixed].abs().max() != 0 or not torch.isfinite(P[: B - 2]).all():
            raise AssertionError(f"project_tangent {tag}: fixed entries must be 0 and regular lanes finite")
        if m >= 3 and not torch.isnan(P[B - 2, 1]):
            raise AssertionError(f"project_tangent {tag}: a NaN factor must give a NaN row")

    # Empty batch: no launch.  Refused operands: a non-contiguous r, a
    # column-major A, a float mask.
    before = dict(kern.LAUNCHES)
    z = lambda *shape, **kw: torch.zeros(shape, device=dev, **kw)
    shapes = (
        kern.masked_aat_cholesky(z(0, 3, 5), z(0, 5, dtype=torch.bool)).shape,
        kern.project_tangent(z(0, 3, 5), z(0, 3, 3), z(0, 5, dtype=torch.bool), z(0, 5)).shape,
    )
    if shapes != ((0, 3, 3), (0, 5)) or kern.LAUNCHES != before:
        raise AssertionError(f"fused kernels, empty batch: shapes {shapes}, launches {kern.LAUNCHES} vs {before}")
    A, fixed, r = _fused_case(rng, 8, 3, 10, False, dev)
    L = kern.masked_aat_cholesky(A, fixed)
    refused = (
        lambda: kern.project_tangent(A, L, fixed, torch.stack([r, r], dim=-1)[..., 0]),
        lambda: kern.project_tangent(A.mT.contiguous().mT, L, fixed, r),
        lambda: kern.masked_aat_cholesky(A.mT.contiguous().mT, fixed),
        lambda: kern.masked_aat_cholesky(A, fixed.float()),
    )
    for i, call in enumerate(refused):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"fused kernels: refused operand {i} was accepted")


def polish_stack(rng, B, d, n, dev, reg=0.0):
    """[JZ; D] as the polish's factor step builds it: a dense (d, n) block
    whose fixed columns (~20%) are zero over diag(fixed ? 1 : sqrt(reg))."""
    fixed = rng.random((B, n)) < 0.2
    JZ = rng.standard_normal((B, d, n)) * ~fixed[:, None, :]
    dbot = np.where(fixed, 1.0, math.sqrt(reg))
    S = np.concatenate([JZ, dbot[:, :, None] * np.eye(n)], axis=1)
    return torch.as_tensor(S, dtype=torch.float32, device=dev)


def conditioned(rng, B, D, N, kappa, dev):
    """(B, D, N) float32 with singular values spaced geometrically from 1 to 1/kappa."""
    U = np.linalg.qr(rng.standard_normal((B, D, N)))[0]
    V = np.linalg.qr(rng.standard_normal((B, N, N)))[0]
    sv = np.logspace(0.0, -math.log10(kappa), N)
    return torch.as_tensor((U * sv) @ np.transpose(V, (0, 2, 1)), dtype=torch.float32, device=dev)


def _library_r(S):
    """`torch.linalg.qr`'s R with every row's sign turned so that the diagonal is positive."""
    R = torch.linalg.qr(S, mode="r")[1]
    d = torch.diagonal(R, dim1=1, dim2=2)
    return R * torch.where(d < 0, -1.0, 1.0).to(R.dtype).unsqueeze(-1)


def _check_r(tag: str, R, S) -> dict:
    """R is upper triangular with a positive diagonal, RᵀR = SᵀS to
    2·N·eps (Frobenius, relative, products in float64), and R agrees with the
    library's sign-normalised R to 4·eps·(√D + κ)·max|R|: the forward error
    of a backward-stable R grows with κ(S), taken here from the library's R."""
    D, N = S.shape[1:]
    eps = float(torch.finfo(S.dtype).eps)
    if not (torch.diagonal(R, dim1=1, dim2=2) > 0).all() or torch.tril(R, -1).abs().max() != 0:
        raise AssertionError(f"{tag}: R must be upper triangular with a positive diagonal")
    Rd, Sd = R.double(), S.double()
    G = Sd.mT @ Sd
    gram = float((torch.linalg.matrix_norm(Rd.mT @ Rd - G) / torch.linalg.matrix_norm(G)).max())
    Rl = _library_r(S)
    sv = torch.linalg.svdvals(Rl.double())
    kappa = float((sv[:, 0] / sv[:, -1]).max())
    err, scale = float((R - Rl).abs().max()), float(Rl.abs().max())
    tol = 4 * eps * (math.sqrt(D) + kappa) * scale
    if not (gram <= 2 * N * eps and err <= tol):
        raise AssertionError(f"{tag}: ‖RᵀR − SᵀS‖/‖SᵀS‖ = {gram:.3e} (≤ {2 * N * eps:.3e}), "
                             f"max |R − library R| = {err:.3e} (≤ {tol:.3e}, κ = {kappa:.3e})")
    return {"gram": gram, "err": err, "tol": tol, "kappa": kappa, "scale": scale}


def _check_blocked_qr(kern, rng, worst) -> None:
    """The panel QR kernel against its plain version, against the library's
    R and against SᵀS."""
    dev = torch.device("cuda:0")
    normal = lambda B, D, N: torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
    cases = {
        "64x1216x192 polish-shaped": polish_stack(rng, 64, 1024, 192, dev),
        "8x300x17": normal(8, 300, 17),                  # one ragged panel
        "5x2048x256 (the gate's corner, width 16)": normal(5, 2048, 256),
        "3x40x40 square": normal(3, 40, 40),
        "6x534x150": normal(6, 534, 150),                # D not a multiple of 4, ragged last panel
        "4x1540x70 (the tallest at width 32)": normal(4, 1540, 70),
        "4x600x96 kappa=1e4": conditioned(rng, 4, 600, 96, 1e4, dev),
        "1x300x40 one instance": normal(1, 300, 40),
    }
    for tag, S in cases.items():
        S0 = S.clone()
        R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
        if not torch.equal(S, S0):
            raise AssertionError(f"blocked_qr_r {tag}: the kernel must not write S")
        c = _check_r(f"blocked_qr_r {tag}", R, S)
        cp = _check_r(f"blocked_qr_r_plain {tag}", Rp, S)
        # Kernel against plain: the same algorithm, other summation order,
        # so the same κ-scaled tolerance as against the library.
        err = float((R - Rp).abs().max())
        if err > c["tol"]:
            raise AssertionError(f"blocked_qr_r {tag}: kernel disagrees with its plain version ({err:.3e} > {c['tol']:.3e})")
        worst("blocked_qr_r", err)
        print(f"blocked_qr_r {tag}: width {kern.qr_panel_layout(S.shape[1], 4)[0]}, vs plain {err:.3e}, "
              f"vs library {c['err']:.3e} (tol {c['tol']:.3e}, κ {c['kappa']:.3e}, max|R| {c['scale']:.3e}), "
              f"Gram {c['gram']:.3e} (plain {cp['gram']:.3e}, tol {2 * S.shape[2] * EPS32:.3e})")

    # float64 through the same source: widths 32 and 8.
    for B, D, N in ((4, 600, 50), (3, 2048, 40)):
        S = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float64, device=dev)
        c = _check_r(f"blocked_qr_r float64 {B}x{D}x{N}", kern.blocked_qr_r(S), S)
        print(f"blocked_qr_r float64 {B}x{D}x{N}: width {kern.qr_panel_layout(D, 8)[0]}, vs library {c['err']:.3e}, Gram {c['gram']:.3e}")

    # A zero column gets the `tiny` floor on the diagonal and zeros beside it;
    # a NaN stays in its own instance.
    S = normal(6, 200, 40)
    S[2, :, 35] = 0.0
    S[4, 17, 3] = float("nan")
    R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
    floor = math.sqrt(float(torch.finfo(torch.float32).tiny))
    if not (abs(float(R[2, 35, 35]) - floor) <= 1e-6 * floor and R[2, 35, 36:].abs().max() == 0
            and torch.isfinite(R[[0, 1, 2, 3, 5]]).all()):
        raise AssertionError("blocked_qr_r: a zero column must give sqrt(tiny) on the diagonal and a finite R")
    if not (torch.isnan(R[4]).any() and torch.equal(torch.isnan(R), torch.isnan(Rp))):
        raise AssertionError("blocked_qr_r: a NaN must stay in its own instance, as in the plain version")

    # Empty batch: no launch.  Refused: a transposed view, D < N, a matrix
    # without a batch, float16, and a CPU tensor handed to the launch check.
    before = dict(kern.LAUNCHES)
    if kern.blocked_qr_r(torch.zeros((0, 50, 20), device=dev)).shape != (0, 20, 20) or kern.LAUNCHES != before:
        raise AssertionError("blocked_qr_r: an empty batch must return (0, N, N) without a launch")
    refused = (
        lambda: kern.blocked_qr_r(normal(2, 20, 50).mT),
        lambda: kern.blocked_qr_r(normal(2, 20, 50)),
        lambda: kern.blocked_qr_r(normal(1, 50, 20)[0]),
        lambda: kern.blocked_qr_r(normal(2, 50, 20).half()),
        lambda: kern._require_cuda("blocked_qr_r", torch.zeros((2, 50, 20))),
    )
    for i, call in enumerate(refused):
        try:
            call()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"blocked_qr_r: refused operand {i} was accepted")
    if kern.LAUNCHES != before:
        raise AssertionError("blocked_qr_r: a refused operand must not count as a launch")


def _time_blocked_qr(kern, rng, rec) -> None:
    """The panel QR kernel, its plain version and `torch.linalg.qr(mode="r")`
    in turns at the polish's shape on config 3 (the record's main keys), at
    a smaller shape and at the corners of `qr_r`'s gate (4 instances, 2048
    rows, 256 columns), where it must be no slower than the library call;
    then below the gate's batch bound, where the library call, which gives
    each matrix the whole card, may win; 20 calls a turn."""
    dev = torch.device("cuda:0")
    shapes = {
        "": polish_stack(rng, 64, 1024, 192, dev),
        "_16x534x150": torch.as_tensor(rng.standard_normal((16, 534, 150)), dtype=torch.float32, device=dev),
        "_4x2048x256": torch.as_tensor(rng.standard_normal((4, 2048, 256)), dtype=torch.float32, device=dev),
        "_64x2048x256": torch.as_tensor(rng.standard_normal((64, 2048, 256)), dtype=torch.float32, device=dev),
        "_4x40x17": torch.as_tensor(rng.standard_normal((4, 40, 17)), dtype=torch.float32, device=dev),
        "_2x2048x256": torch.as_tensor(rng.standard_normal((2, 2048, 256)), dtype=torch.float32, device=dev),
        "_1x1216x192": torch.as_tensor(rng.standard_normal((1, 1216, 192)), dtype=torch.float32, device=dev),
    }
    for suffix, S in shapes.items():
        t = _in_turns({"plain": lambda: kern.blocked_qr_r_plain(S), "kernel": lambda: kern.blocked_qr_r(S),
                       "library": lambda: torch.linalg.qr(S, mode="r")}, reps=20, warm=3)
        bound = _r_bound(*S.shape)
        rec["blocked_qr_r"].update({
            "ms" + suffix: t["kernel"], "plain_ms" + suffix: t["plain"], "library_ms" + suffix: t["library"],
            **{k + suffix: bound[k] for k in ("bound_ms", "bound_us", "bound_by")},
        })
        shape = "x".join(map(str, S.shape))
        print(f"blocked_qr_r {shape}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"library {t['library']:.4f} ms, bound {bound['bound_us']:.4f} us "
              f"({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")
        if S.shape[0] >= kern.MIN_BLOCKED_QR_BATCH and t["kernel"] > t["library"]:
            raise AssertionError(f"blocked_qr_r {shape}: slower than the library call inside qr_r's gate")
    rec["blocked_qr_r"]["shape"] = "64x1216x192"


def _time_kernels(kern, rng, rec) -> None:
    """Times at each path's shapes, in turns, with bounds and library calls.

    Config 2: the bulk factors and projects at the chunk width
    (512, m = 1, n = 3) with a per-instance A, the certification's QR runs
    at B = 1024.  Config 3: (64, m = 6, n = 192) with one A shared by the
    batch (a stride-0 expand), the polish's thin_qr(Wᵀ) at (64, 192, 6)."""
    dev = torch.device("cuda:0")
    f32 = torch.float32
    paths = {}
    for suffix, (B, m, n, shared, qr_shape) in {
        "": (512, 1, 3, False, (1024, 35, 3)), "_config3": (64, 6, 192, True, (64, 192, 6)),
    }.items():
        A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        fixed[B - 2:] = fixed[0]     # no degenerate lanes in the timed batch
        if shared:                    # a generic shared matrix, as the path has
            A = torch.as_tensor(rng.standard_normal((m, n)), dtype=f32, device=dev).expand(B, m, n)
        L = kern.masked_aat_cholesky(A, fixed)
        K = (L @ L.mT).contiguous()
        b = torch.as_tensor(rng.standard_normal((B, m)), dtype=f32, device=dev)
        S = torch.as_tensor(rng.standard_normal(qr_shape), dtype=f32, device=dev)
        n_free = int((~fixed).sum())
        a_bytes = (1 if shared else B) * m * n * 4
        paths[suffix] = {
            "batched_cholesky": dict(
                shape=f"{B}x{m}x{m}", kernel=lambda K=K: kern.batched_cholesky(K),
                plain=lambda K=K: kern.batched_cholesky_plain(K), library=lambda K=K: torch.linalg.cholesky_ex(K),
                bound=_bound(2 * B * m * m * 4, B * m ** 3 / 3)),
            "batched_cho_solve": dict(
                shape=f"{B}x{m}", kernel=lambda L=L, b=b: kern.batched_cho_solve(L, b),
                plain=lambda L=L, b=b: kern.batched_cho_solve_plain(L, b),
                library=lambda L=L, b=b: torch.cholesky_solve(b.unsqueeze(-1), L),
                bound=_bound(B * (m * m + 2 * m) * 4, 2 * B * m * m)),
            "batched_thin_qr": dict(
                shape="x".join(map(str, qr_shape)), kernel=lambda S=S: kern.batched_thin_qr(S),
                plain=lambda S=S: kern.batched_thin_qr_plain(S), library=lambda S=S: torch.linalg.qr(S, mode="reduced"),
                bound=_qr_bound(*qr_shape)),
            "masked_aat_cholesky": dict(
                shape=f"{B}x{m}x{n}{' shared A' if shared else ''}",
                kernel=lambda A=A, fixed=fixed: kern.masked_aat_cholesky(A, fixed),
                plain=lambda A=A, fixed=fixed: kern.masked_aat_cholesky_plain(A, fixed),
                old_site=lambda A=A, fixed=fixed: old_factor_site(kern, A, fixed),
                bound=_bound(a_bytes + B * n + B * m * m * 4, m * (m + 1) * n_free + B * m ** 3 / 3)),
            "project_tangent": dict(
                shape=f"{B}x{m}x{n}{' shared A' if shared else ''}",
                kernel=lambda A=A, L=L, fixed=fixed, r=r: kern.project_tangent(A, L, fixed, r),
                plain=lambda A=A, L=L, fixed=fixed, r=r: kern.project_tangent_plain(A, L, fixed, r),
                old_site=lambda A=A, L=L, fixed=fixed, r=r: old_project_site(kern, A, L, fixed, r),
                bound=_bound(a_bytes + B * m * m * 4 + B * n + 2 * B * n * 4, 4 * m * n_free + 2 * B * m * m)),
        }
    _time_blocked_qr(kern, rng, rec)
    for name in next(iter(paths.values())):
        for suffix, cases in paths.items():
            case = cases[name]
            yard = "library" if "library" in case else "old_site"
            t = _in_turns({"plain": case["plain"], "kernel": case["kernel"], yard: case[yard]})
            rec[name].update({
                "ms" + suffix: t["kernel"], "plain_ms" + suffix: t["plain"],
                "library_ms" + suffix: t.get("library"),
                **{k + suffix: case["bound"][k] for k in ("bound_ms", "bound_us", "bound_by")},
            })
            if yard == "old_site":
                rec[name]["old_site_ms" + suffix] = t["old_site"]
            print(f"{name} {case['shape']}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
                  f"{yard.replace('_', ' ')} {t[yard]:.4f} ms, bound {case['bound']['bound_us']:.4f} us "
                  f"({case['bound']['bound_by']}: {case['bound']['bytes']} B, {case['bound']['flops']} flop)")
    # The narrow QR at the other call sites' shapes: the multiplier estimate's
    # thin_qr(Cᵀ) (config 2's polish has the same shape), the config-1
    # polish's qr_r([JZ; D]) and thin_qr(Wᵀ), and one instance.
    # Config 5's polish runs both at the sweep chunk's 16,384 lanes, where
    # the library call takes about a second: 5 calls a turn there.
    for shape in ((1024, 3, 1), (1024, 7, 3), (1024, 3, 2), (1, 3, 1), (16384, 35, 3), (16384, 3, 1)):
        W = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
        _time_extra(rec, "batched_thin_qr", shape, _qr_bound(*shape), {
            "plain": lambda W=W: kern.batched_thin_qr_plain(W), "kernel": lambda W=W: kern.batched_thin_qr(W),
            "library": lambda W=W: torch.linalg.qr(W, mode="reduced")},
            *((5, 2) if shape[0] > 1024 else ()))
    # One instance (a float32 `solve` at B = 1), n = 3, m = 1.
    A, fixed, r = (t[:1].contiguous() for t in _fused_case(rng, 3, 1, 3, False, dev))
    L = kern.masked_aat_cholesky(A, fixed)
    b = torch.as_tensor(rng.standard_normal((1, 1)), dtype=f32, device=dev)
    n_free = int((~fixed).sum())
    _time_extra(rec, "masked_aat_cholesky", (1, 1, 3), _bound(12 + 3 + 4, 2 * n_free + 1 / 3), {
        "plain": lambda: kern.masked_aat_cholesky_plain(A, fixed), "kernel": lambda: kern.masked_aat_cholesky(A, fixed),
        "old_site": lambda: old_factor_site(kern, A, fixed)})
    _time_extra(rec, "project_tangent", (1, 1, 3), _bound(12 + 4 + 3 + 24, 4 * n_free + 2), {
        "plain": lambda: kern.project_tangent_plain(A, L, fixed, r), "kernel": lambda: kern.project_tangent(A, L, fixed, r),
        "old_site": lambda: old_project_site(kern, A, L, fixed, r)})
    _time_extra(rec, "batched_cho_solve", (1, 1), _bound(12, 2), {
        "plain": lambda: kern.batched_cho_solve_plain(L, b), "kernel": lambda: kern.batched_cho_solve(L, b),
        "library": lambda: torch.cholesky_solve(b.unsqueeze(-1), L)})
    K = (L @ L.mT).contiguous()
    _time_extra(rec, "batched_cholesky", (1, 1, 1), _bound(8, 1 / 3), {
        "plain": lambda: kern.batched_cholesky_plain(K), "kernel": lambda: kern.batched_cholesky(K),
        "library": lambda: torch.linalg.cholesky_ex(K)})
    # Config 4: one instance, m = 8 equalities over n = 10,240 columns (a
    # single warp strides over them); the solve at (1, 8) in the dual Newton.
    m, n = 8, 10240
    A, fixed, r = (t[:1].contiguous() for t in _fused_case(rng, 3, m, n, False, dev))
    L = kern.masked_aat_cholesky(A, fixed)
    b = torch.as_tensor(rng.standard_normal((1, m)), dtype=f32, device=dev)
    n_free = int((~fixed).sum())
    _time_extra(rec, "masked_aat_cholesky", (1, m, n), _bound(m * n * 4 + n + m * m * 4, m * (m + 1) * n_free + m ** 3 / 3), {
        "plain": lambda: kern.masked_aat_cholesky_plain(A, fixed), "kernel": lambda: kern.masked_aat_cholesky(A, fixed),
        "old_site": lambda: old_factor_site(kern, A, fixed)})
    _time_extra(rec, "project_tangent", (1, m, n), _bound(m * n * 4 + m * m * 4 + n + 2 * n * 4, 4 * m * n_free + 2 * m * m), {
        "plain": lambda: kern.project_tangent_plain(A, L, fixed, r), "kernel": lambda: kern.project_tangent(A, L, fixed, r),
        "old_site": lambda: old_project_site(kern, A, L, fixed, r)})
    _time_extra(rec, "batched_cho_solve", (1, m), _bound((m * m + 2 * m) * 4, 2 * m * m), {
        "plain": lambda: kern.batched_cho_solve_plain(L, b), "kernel": lambda: kern.batched_cho_solve(L, b),
        "library": lambda: torch.cholesky_solve(b.unsqueeze(-1), L)})


def _time_extra(rec: dict, name: str, shape: tuple, bound: dict, fns: dict, reps: int = 200, warm: int = 10) -> None:
    """Time one kernel at one more shape, in turns with its plain version
    and its library call (or the call site it replaces); the record's keys
    carry the shape as a suffix."""
    t = _in_turns(fns, reps, warm)
    yard = "library" if "library" in fns else "old_site"
    suffix = "_" + "x".join(map(str, shape))
    rec[name].update({"ms" + suffix: t["kernel"], "plain_ms" + suffix: t["plain"], f"{yard}_ms" + suffix: t[yard],
                      "bound_us" + suffix: bound["bound_us"], "bound_by" + suffix: bound["bound_by"]})
    print(f"{name} {suffix[1:]}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, {yard.replace('_', ' ')} {t[yard]:.4f} ms, "
          f"bound {bound['bound_us']:.4f} us ({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")


def _check_launched(tag: str, launches: dict, names=PATH_KERNELS) -> None:
    """Every kernel of the path was launched in the run just made."""
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched on this path")


def _oracle_agreement(tag: str, points) -> int:
    """How many of the points pass the port's numpy KKT oracle; verdicts of
    its fully-active branch (lsq_linear convergence unchecked) are flagged."""
    from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_point

    verdicts = [kkt_check_point(*p) for p in points]
    flagged = sum(bool(v.get("degenerate_all_active")) for v in verdicts)
    agree = sum(v["ok"] for v in verdicts)
    print(f"{tag} oracle: {agree}/{len(verdicts)} instances pass the numpy KKT check "
          f"({flagged} verdicts from the fully-active branch)")
    return agree


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
    print(f"config 2, B={B}: certified {n_cert}/{B}, max pix {pix_max:.3e}, "
          f"cold {cold:.3f} s, warm {warm:.3f} s, launches {launches}")
    if X.shape != (B, 3) or X.dtype != torch.float64 or not torch.isfinite(X).all():
        raise AssertionError("slice: X must be finite float64 of shape (1024, 3)")
    if n_cert != B or pix_max > CERT_PIX:
        raise AssertionError(f"slice: {n_cert}/{B} certified, max pix {pix_max:.3e} (need {B} at ≤ {CERT_PIX:.3e})")
    if not torch.equal(info2.converged, info.converged) or float((X2 - X).abs().max()) > SMALL_ATOL:
        raise AssertionError("slice: the warm run disagrees with the cold run")
    _check_launched("config 2", launches)

    # Independent first-principles KKT oracle on 128 sampled instances.
    fns = bp.instance_fns(theta)
    r = fns.residuals(X).cpu().numpy()
    J = fns.jac_res(X).cpu().numpy()
    Xh = X.cpu().numpy()
    A = bp.A.cpu().numpy()
    b_rhs = bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    sample = np.random.default_rng(0).choice(B, size=128, replace=False)
    agree = _oracle_agreement(
        "config 2", [(Xh[i], r[i], J[i], None, None, A, b_rhs[i], xl, xu) for i in sample]
    )
    if agree != 128:
        raise AssertionError(f"oracle agrees on {agree}/128")

    # The card against the port's CPU run (plain versions) on a small batch.
    bp_s, th_s, X0_s = exp_fit_family(64, d=32, seed=42, dtype=torch.float64, device="cpu")
    Xc, _, ic = solve_mixed_precision(bp_s, th_s, X0_s, opts)
    bp_g, th_g, X0_g = exp_fit_family(64, d=32, seed=42, dtype=torch.float64, device=dev)
    Xg, _, ig = solve_mixed_precision(bp_g, th_g, X0_g, opts)
    diff = float((Xg.cpu() - Xc).abs().max())
    print(f"config 2 small batch (64): card vs CPU max |dX| {diff:.3e}, certified {int(ig.converged.sum())}/64 vs {int(ic.converged.sum())}/64")
    if not (bool(ig.converged.all()) and bool(ic.converged.all()) and diff <= SMALL_ATOL):
        raise AssertionError("small batch: the card's run disagrees with the CPU run")
    return {"launches": launches, "cold_s": cold, "warm_s": warm, "certified": n_cert, "pix_max": pix_max}


def _walled(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


# The fused path against the unfused one on the card: the JAX package's
# fused-vs-unfused bar (tests/test_polish.py), two certified f64 points.
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-8


@contextlib.contextmanager
def _stages_eagerly():
    """Run `fuse=True`'s stages as plain calls on the card: the graphs'
    comparison."""
    from benlsip_tpu_torch.batch import fused_small

    fused_small._USE_GRAPHS = False
    try:
        yield
    finally:
        fused_small._USE_GRAPHS = True


def _check_while_nodes() -> None:
    """Two nested masked loops captured as WHILE nodes (`_loops` capture
    mode) and replayed equal the eager loops, again after the loops' data
    change in place: the trip counts are decided on the device."""
    from typing import NamedTuple

    from benlsip_tpu_torch import _loops

    class Carry(NamedTuple):
        v: torch.Tensor
        k: torch.Tensor

    dev = torch.device("cuda:0")
    bound = torch.tensor([2, 5, 5, 7], dtype=torch.int32, device=dev)
    run = torch.tensor([True, True, False, True], device=dev)
    c0 = Carry(torch.zeros(4, device=dev), torch.zeros(4, dtype=torch.int32, device=dev))

    def outer_body(c, act):
        inner = _loops.masked_while(lambda d: d.k < 3, lambda d, a: Carry(d.v + 0.5, d.k + 1),
                                    Carry(c.v, torch.zeros_like(c.k)), act, 5)
        return Carry(inner.v + 1, c.k + 1)

    loop = lambda: _loops.masked_while(lambda c: c.k < bound, outer_body, c0, run, 9)   # cap: the largest bound
    graph = torch.cuda.CUDAGraph()
    with _loops.loop_mode("capture"), torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        got = loop()
    for new_bound in ([2, 5, 5, 7], [1, 9, 1, 3]):
        bound.copy_(torch.tensor(new_bound, dtype=torch.int32))
        graph.replay()
        want = loop()
        _require(torch.equal(got.v, want.v) and torch.equal(got.k, want.k),
                 f"WHILE nodes: replay {got} differs from the eager loops {want} at bounds {new_bound}")
    print(f"fused: nested masked loops as WHILE nodes, replayed at two sets of bounds, equal the eager loops ({got.k.tolist()} trips)")


def _check_captured_kernels(kern) -> None:
    """Each kernel of the config-2 path captured alone into a CUDA graph at
    the path's shapes and replayed: the replay equals the eager call."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    A, fixed, r = _fused_case(rng, 512, 1, 3, False, dev)
    fixed[510:] = fixed[0]
    L = kern.masked_aat_cholesky(A, fixed)
    b = torch.as_tensor(rng.standard_normal((512, 1)), dtype=torch.float32, device=dev)
    S = torch.as_tensor(rng.standard_normal((1024, 35, 3)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.standard_normal((1024, 3, 1)), dtype=torch.float32, device=dev)
    calls = {
        "masked_aat_cholesky": lambda: kern.masked_aat_cholesky(A, fixed),
        "project_tangent": lambda: kern.project_tangent(A, L, fixed, r),
        "batched_cho_solve": lambda: kern.batched_cho_solve(L, b),
        "batched_thin_qr": lambda: kern.batched_thin_qr(S) + kern.batched_thin_qr(W),
    }
    stream = torch.cuda.Stream()
    for name, fn in calls.items():
        want = fn()
        before = kern.CAPTURED[name]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = fn()
        graph.replay()
        _sync()
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        _require(kern.CAPTURED[name] > before, f"{name}: the capture recorded no launch")
        _require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: the graph's replay differs from the eager call")
    print(f"fused: each path kernel captured at config-2 shapes and replayed equals its eager call ({', '.join(calls)})")


def phase_fused(kern, smi: str, profile: bool) -> dict:
    """The fused config-2 path: `solve_mixed_precision(..., fuse=True)` as
    CUDA-graph replays (`batch/fused_small.py`) on the config-2 family, cold
    and warm, against the unfused run and the same fused code run eagerly."""
    from benlsip_tpu_torch import _loops
    from benlsip_tpu_torch.batch import fused_small
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import exp_fit_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    t_phase = time.perf_counter()
    print(f"fused: torch {torch.__version__}, CUDA {torch.version.cuda}; torch's own conditional-node capture "
          f"(CUDAGraph.begin_capture_to_if_node) {'present' if hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node') else 'absent'}; "
          "the port adds conditional WHILE nodes through csrc/graph_conditional.cu")
    _check_while_nodes()
    _check_captured_kernels(kern)
    dev = torch.device("cuda:0")
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    B = 1024
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=torch.float64, device=dev)
    fused = lambda: solve_mixed_precision(bp, theta, X0, opts, fuse=True)
    plain = lambda: solve_mixed_precision(bp, theta, X0, opts)

    kern.reset_launches()
    fused_small.reset_graph_stats()
    _loops.reset_host_syncs()
    (X, Y, info), cold = _walled(fused)
    cold_syncs = _loops.HOST_SYNCS
    captured = dict(kern.CAPTURED)
    stats = list(fused_small.GRAPH_STATS)
    kern.reset_launches()
    _loops.reset_host_syncs()
    fused_small.reset_replay_counts()
    (X2, _, info2), warm0 = _walled(fused)
    syncs = {"fused": _loops.HOST_SYNCS}
    launches, replay = dict(kern.LAUNCHES), fused_small.replay_counts()
    executed = replay["launches"]
    _check_certified("fused config 2", X, info, B, 3)
    _require(torch.equal(X2, X) and torch.equal(info2.converged, info.converged), "fused config 2: the warm run differs from the cold run")
    _require(not any(launches.values()), f"fused config 2: a warm call launched kernels outside its graphs: {launches}")
    capture_s = sum(s["capture_s"] for s in stats)
    instantiate_s = sum(s["instantiate_s"] for s in stats)
    for s in stats:
        print(f"fused graph {s['stage']}: capture {s['capture_s']:.3f} s, instantiate {s['instantiate_s']:.3f} s, captured launches {s['captured_launches']}")
    print(f"fused config 2, B={B}: certified {int(info.converged.sum())}/{B}, max pix {float(info.pix.max()):.3e}, cold {cold:.3f} s "
          f"({len(stats)} graphs, capture {capture_s:.3f} s, instantiate {instantiate_s:.3f} s, {cold_syncs} host syncs), "
          f"first warm {warm0:.3f} s on {smi}")

    # Against the unfused run on the card, and the same fused code run eagerly.
    _loops.reset_host_syncs()
    (Xu, _, iu), _ = _walled(plain)
    syncs["unfused"] = _loops.HOST_SYNCS
    du = float((X - Xu).abs().max())
    _require(torch.equal(iu.converged, info.converged) and torch.allclose(X, Xu, rtol=FUSED_RTOL, atol=FUSED_ATOL),
             f"fused config 2: disagrees with the unfused run (max |dX| {du:.3e})")
    with _stages_eagerly():
        fused()
        kern.reset_launches()
        _loops.reset_host_syncs()
        (Xe, _, ie), eager_wall = _walled(fused)
    syncs["fused_eager"] = _loops.HOST_SYNCS
    eager_launches = dict(kern.LAUNCHES)
    de = float((X - Xe).abs().max())
    print(f"fused config 2: max |dX| captured vs unfused {du:.3e} (rtol {FUSED_RTOL:g}, atol {FUSED_ATOL:g}), captured vs the "
          f"same stages run eagerly {de:.3e} ({'identical' if de == 0 else 'not identical'}; eager fused wall {eager_wall:.3f} s)")
    _require(torch.equal(ie.converged, info.converged) and torch.allclose(X, Xe, rtol=FUSED_RTOL, atol=FUSED_ATOL),
             f"fused config 2: the graphs disagree with the same stages run eagerly (max |dX| {de:.3e})")
    print(f"fused config 2: host syncs per warm call: unfused {syncs['unfused']}, fused as graphs {syncs['fused']}, "
          f"fused stages run eagerly {syncs['fused_eager']}")
    # The replays run every trip the eager loops run, and branches the host
    # skips eagerly when no lane needs them.
    print(f"fused config 2: a warm call's {replay['replays']} graph replays ran {replay['loop_trips']} WHILE-node trips, "
          f"{replay['device_kernels']} device kernels and {replay['device_copies']} copies (node counts x trips); "
          f"path kernels run by the replays {executed}, "
          f"launched by the same stages run eagerly {eager_launches}")
    for name in PATH_KERNELS:
        _require(captured[name] > 0 and executed[name] > 0, f"fused config 2: kernel {name} captured {captured[name]}, run by the replays {executed[name]}")
    _require(all(executed[k] >= eager_launches[k] for k in PATH_KERNELS),
             f"fused config 2: the replays ran fewer path kernels ({executed}) than the same stages eagerly ({eager_launches})")

    # The oracle on 128 sampled instances.
    fns = bp.instance_fns(theta)
    r, J = fns.residuals(X).cpu().numpy(), fns.jac_res(X).cpu().numpy()
    Xh, A, b_rhs = X.cpu().numpy(), bp.A.cpu().numpy(), bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    sample = np.random.default_rng(0).choice(B, size=128, replace=False)
    agree = _oracle_agreement("fused config 2", [(Xh[i], r[i], J[i], None, None, A, b_rhs[i], xl, xu) for i in sample])
    _require(agree == 128, f"fused config 2: oracle agrees on {agree}/128")

    # Warm walls in turns: unfused, fused, fused, unfused, ...
    walls = {"fused": [], "unfused": []}
    for i in range(5):
        for name in (("unfused", "fused") if i % 2 == 0 else ("fused", "unfused")):
            walls[name].append(_walled(fused if name == "fused" else plain)[1])
    for name, w in walls.items():
        print(f"fused config 2: warm wall {name} (5 calls in turns) median {float(np.median(w)):.4f} s, "
              f"range {min(w):.4f}-{max(w):.4f} s, all {[round(x, 4) for x in w]} on {smi}")
    res = {"cold_s": cold, "warm_s": walls, "syncs": syncs, "captured": captured, "executed": executed,
           "device_kernels": replay["device_kernels"], "capture_s": capture_s, "instantiate_s": instantiate_s,
           "graphs": len(stats)}
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        # A trace holds each node of a graph's top level once a launch, not
        # the kernels that its WHILE bodies run trip after trip: for the
        # fused path the traced kernels and busy time undercount.  The
        # device's span from the call's first to its last operation (CUDA
        # events; gaps inside the graph included) bounds its busy time, the
        # graphs count its kernels exactly, and its kernel time is that of
        # the same stages traced eagerly (the same kernels on the same data).
        spans = {}
        for name, fn in (("fused", fused), ("unfused", plain)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            _sync()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            _sync()
            wall, span = time.perf_counter() - t0, start.elapsed_time(end) / 1e3
            spans[name] = (wall, span)
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced = _walled(fn)[1]
            events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_us = sum(e.self_device_time_total for e in events)
            on_device = {k: sum(e.count for e in events if re.search(rf"\b{DEVICE_NAMES[k]}[<(]", e.key))
                         for k in PATH_KERNELS}
            print(f"profile fused config 2 ({name}): wall {wall:.4f} s, device span {span:.4f} s ({100 * span / wall:.1f}%); "
                  f"traced wall {traced:.3f} s, traced device time {dev_us / 1e6:.4f} s ({100 * dev_us / 1e6 / traced:.1f}%), "
                  f"{sum(e.count for e in events)} traced device kernels, path kernels in the trace {on_device}")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"profile fused config 2 ({name}): {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<7d} {e.key[:80]}")
        with _stages_eagerly(), torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = _walled(fused)[1]
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in events) / 1e6
        wall, span = spans["fused"]
        print(f"profile fused config 2 (graphs): {replay['device_kernels']} device kernels + {replay['device_copies']} copies "
              f"run by a warm call's replays (exact); the same stages traced eagerly: {sum(e.count for e in events)} device "
              f"operations, {dev_s:.4f} s of device time (traced wall {traced:.3f} s); busy share of the fused call "
              f"{100 * dev_s / wall:.1f}% of its wall {wall:.4f} s, {100 * dev_s / span:.1f}% of its device span on {smi}")
        res["busy_share"] = dev_s / wall
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"fused phase: {res['phase_s']:.1f} s")
    return res


def _check_certified(tag: str, X, info, B: int, n: int) -> None:
    n_cert, pix_max = int(info.converged.sum()), float(info.pix.max())
    if X.shape != (B, n) or X.dtype != torch.float64 or not torch.isfinite(X).all():
        raise AssertionError(f"{tag}: X must be finite float64 of shape ({B}, {n})")
    if n_cert != B or pix_max > CERT_PIX:
        raise AssertionError(f"{tag}: {n_cert}/{B} certified, max pix {pix_max:.3e} (need {B} at ≤ {CERT_PIX:.3e})")


def phase_config3(kern) -> dict:
    """Config 3 (`bench.py:130-179` in the JAX package): the dense path with
    the materialized Gauss-Newton operator, both certify modes."""
    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family
    from benlsip_tpu_torch.solver import subproblem
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = torch.device("cuda:0")
    B, n, d, m = 64, 192, 1024, 6
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp, theta, X0 = dense_quadratic_family(B, n=n, d=d, m=m, seed=3, dtype=torch.float64, device=dev)
    run = lambda certify: solve_mixed_precision(bp, theta, X0, opts, chunk=B, certify=certify)

    kern.reset_launches()
    subproblem.reset_operator_builds()
    (X, Y, info), cold = _walled(lambda: run("auto"))
    launches = dict(kern.LAUNCHES)
    builds = {f"{fact}/{dt}": k for (fact, dt), k in subproblem.OPERATOR_BUILDS.items()}
    print(f"config 3: operator builds in the cold run (factorization/dtype: count) = {builds}")
    bulk_builds = {k: v for k, v in builds.items() if k.endswith("/float32")}
    if list(bulk_builds) != ["cholqr2/float32"] or bulk_builds["cholqr2/float32"] <= 0:
        raise AssertionError(f"config 3: the bulk must build only the CholeskyQR2 operator, built {builds}")
    (X2, _, info2), warm = _walled(lambda: run("auto"))
    print(f"config 3, B={B}: certified {int(info.converged.sum())}/{B}, max pix {float(info.pix.max()):.3e}, "
          f"cold {cold:.3f} s, warm {warm:.3f} s, launches {launches}")
    _check_certified("config 3 cold", X, info, B, n)
    _check_certified("config 3 warm", X2, info2, B, n)
    if not torch.equal(info2.converged, info.converged) or float((X2 - X).abs().max()) > SMALL_ATOL:
        raise AssertionError("config 3: the warm run disagrees with the cold run")
    _check_launched("config 3", launches, CONFIG3_KERNELS)

    # Host certification (f32 factors on the card, f64 chord on the CPU).
    kern.reset_launches()
    (Xh, _, info_h), host_cold = _walled(lambda: run("host"))
    launches_host = dict(kern.LAUNCHES)
    _check_launched("config 3 certify=host", launches_host, CONFIG3_KERNELS)
    print(f"config 3: blocked_qr_r launches a run: {launches['blocked_qr_r']} (certify=auto), "
          f"{launches_host['blocked_qr_r']} (certify=host)")
    (_, _, _), host_warm = _walled(lambda: run("host"))
    print(f"config 3 certify=host: certified {int(info_h.converged.sum())}/{B}, max pix {float(info_h.pix.max()):.3e}, "
          f"cold {host_cold:.3f} s, warm {host_warm:.3f} s, max |dX| vs device {float((Xh - X.cpu()).abs().max()):.3e}")
    _check_certified("config 3 certify=host", Xh, info_h, B, n)

    # Warm bulk alone, for the bulk / certification split.
    bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(theta, torch.float32)
    bulk_opts = SolverOptions(max_outer_iter=30, max_inner_iter=100, crit_tol=1e-2)
    _, bulk = _walled(lambda: solve_batched_chunked(bp32, th32, X0.float(), bulk_opts, chunk=B))
    print(f"config 3 split: warm bulk {bulk:.3f} s, certification device {warm - bulk:.3f} s, "
          f"host {host_warm - bulk:.3f} s")

    fns = bp.instance_fns(theta)
    r = fns.residuals(X).cpu().numpy()
    J = fns.jac_res(X)[0].cpu().numpy()   # shared by every instance (a stride-0 expand)
    Xn = X.cpu().numpy()
    A, b_rhs = bp.A.cpu().numpy(), bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    agree = _oracle_agreement("config 3", [(Xn[i], r[i], J, None, None, A, b_rhs, xl, xu) for i in range(B)])
    if agree != B:
        raise AssertionError(f"config 3: oracle agrees on {agree}/{B}")

    bp_c, th_c, X0_c = dense_quadratic_family(8, n=n, d=d, m=m, seed=3, dtype=torch.float64, device="cpu")
    Xc, _, ic = solve_mixed_precision(bp_c, th_c, X0_c, opts, chunk=8)
    bp_g, th_g, X0_g = dense_quadratic_family(8, n=n, d=d, m=m, seed=3, dtype=torch.float64, device=dev)
    Xg, _, ig = solve_mixed_precision(bp_g, th_g, X0_g, opts, chunk=8)
    diff = float((Xg.cpu() - Xc).abs().max())
    print(f"config 3 small batch (8): card vs CPU max |dX| {diff:.3e}, "
          f"certified {int(ig.converged.sum())}/8 vs {int(ic.converged.sum())}/8")
    if not (bool(ig.converged.all()) and bool(ic.converged.all()) and diff <= SMALL_ATOL):
        raise AssertionError("config 3 small batch: the card's run disagrees with the CPU run")
    return {"launches": launches, "launches_host": launches_host, "cold_s": cold, "warm_s": warm,
            "host_cold_s": host_cold, "host_warm_s": host_warm, "bulk_s": bulk}


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _single_solves(kern) -> dict:
    """Config 1, steps 1-2: one instance through `solve` and `tralcnllss`."""
    from benlsip_tpu_torch import SolverOptions, solve, tralcnllss
    from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_problem_point
    from benlsip_tpu_torch.problems import rosenbrock, sphere_regression as sr

    opts = SolverOptions(max_outer_iter=100, max_inner_iter=250)
    x_star = torch.tensor(SPHERE_X_STAR, dtype=torch.float64)

    def timed(fn):
        fn()
        (out, wall) = _walled(fn)
        return out, wall

    # Float64 on the card (x0() creates its tensor on the default device, the card).
    problem = sr.make_problem()
    (x, y, info), wall = timed(lambda: solve(problem, sr.x0(), opts))
    (xc, _, info_c), wall_cpu = timed(lambda: solve(problem, sr.x0(device="cpu"), opts))
    feas = float(torch.linalg.vector_norm(sr.nlconstraints(x)))
    verdict = kkt_check_problem_point(problem, x)
    print(f"config 1 solve(sphere_regression) float64: x = {x.tolist()}, converged {bool(info.converged)}, ||c|| {feas:.3e}, "
          f"outer {int(info.outer_iters)}, inner {int(info.inner_iters)}, |x - x*| {float((x.cpu() - x_star).abs().max()):.3e}, "
          f"|x - CPU run| {float((x.cpu() - xc).abs().max()):.3e}, oracle {verdict['ok']}; "
          f"warm wall card {wall:.3f} s, CPU {wall_cpu:.3f} s ({wall / wall_cpu:.2f}x)")
    _require(x.device.type == "cuda" and x.dtype == torch.float64 and all(f.ndim == 0 for f in info),
             "solve: x must be float64 on the card and SolveInfo 0-dim")
    _require(bool(info.converged) and feas < 1.5e-8, f"solve: converged {bool(info.converged)}, ||c|| {feas:.3e}")
    _require(float((x.cpu() - x_star).abs().max()) <= 1e-6, "solve: x is not the fixture's optimum")
    _require(verdict["ok"], f"solve: the KKT oracle rejects x: {verdict}")
    _require(bool(info_c.converged) and float((x.cpu() - xc).abs().max()) <= 1e-9, "solve: the card disagrees with the CPU run")

    # The reference-parity entry, autodiff Jacobians, a warm start from y.
    xt, _, it = tralcnllss(sr.x0(), sr.residuals, sr.jac_res, sr.nlconstraints, sr.jac_nlcons,
                           sr.A, sr.b, sr.xl, sr.xu, max_outer_iter=100, max_inner_iter=250)
    xa, _, ia = solve(sr.make_problem(analytic_jacobians=False), [1.0, 0.5, 1.5], opts)   # a list x0: created on the card
    xw, _, iw = solve(problem, sr.x0(), opts, y0=y)
    print(f"config 1 tralcnllss |dx| {float((xt - x).abs().max()):.3e}; autodiff |dx| {float((xa - x).abs().max()):.3e}; "
          f"warm start from y: outer {int(iw.outer_iters)} (cold {int(info.outer_iters)}), |dx| {float((xw - x).abs().max()):.3e}")
    _require(bool(it.converged) and torch.equal(xt, x), "tralcnllss: not the same solve as solve()")
    _require(bool(ia.converged) and xa.device.type == "cuda" and float((xa - x).abs().max()) <= 1e-6, "solve: autodiff Jacobians reach another point")
    _require(bool(iw.converged) and int(iw.outer_iters) <= int(info.outer_iters) and float((xw - x).abs().max()) <= 1e-7,
             "solve: the warm start from y must converge to the same x in no more outer iterations")

    # Float32 at B = 1: every kernel of the path on a grid of one block.
    kern.reset_launches()
    (x32, _, i32), _ = _walled(lambda: solve(problem, sr.x0(torch.float32), opts))
    launches = dict(kern.LAUNCHES)
    _, wall32 = _walled(lambda: solve(problem, sr.x0(torch.float32), opts))
    print(f"config 1 solve(sphere_regression) float32, B = 1: converged {bool(i32.converged)}, pix {float(i32.pix):.3e}, "
          f"feas {float(i32.feas):.3e}, |x - x*| {float((x32.cpu().double() - x_star).abs().max()):.3e}, "
          f"warm wall {wall32:.3f} s, launches {launches}")
    _require(x32.dtype == torch.float32 and bool(i32.converged) and float((x32.cpu().double() - x_star).abs().max()) <= 1e-3,
             "float32 solve at B = 1: not converged at the float32 tolerance")
    _check_launched("config 1 float32 B = 1", launches)
    # No equalities (m = 0): no factor and no projection launch.
    kern.reset_launches()
    xr, _, ir = solve(rosenbrock.make_problem(bounded=True), rosenbrock.x0(torch.float32), SolverOptions())
    no_eq = dict(kern.LAUNCHES)
    print(f"config 1 solve(rosenbrock, bounded) float32, m = 0: x = {xr.tolist()}, converged {bool(ir.converged)}, launches {no_eq}")
    _require(bool(ir.converged) and float((xr.cpu() - 1.0).abs().max()) <= 1e-3, "float32 bounded Rosenbrock: not at (1, 1)")
    _require(no_eq["masked_aat_cholesky"] == 0 and no_eq["project_tangent"] == 0, "m = 0 must launch no factor or projection kernel")
    return {"launches_b1": launches, "solve_f64_s": wall, "solve_f64_cpu_s": wall_cpu, "solve_f32_s": wall32}


def _classic_battery() -> dict:
    """Config 1, step 3: the 18 classic problems in float64 on the card."""
    from benlsip_tpu_torch import is_feasible
    from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_classic_battery
    from benlsip_tpu_torch.problems.classic import REGISTRY

    t0 = time.perf_counter()
    res = kkt_check_classic_battery()   # device=None: the card
    total = time.perf_counter() - t0
    details = res["battery_details"]
    for name, d in details.items():
        rec = REGISTRY[name]
        problem = rec.make_problem()
        x = torch.as_tensor(d["x"])
        fns, poly = problem.build(x.shape[0], torch.float64, "cpu")
        cx = fns.nlconstraints(x[None])[0]
        f = 0.5 * float((fns.residuals(x[None]) ** 2).sum())
        err = None if rec.x_star is None else float((x - torch.tensor(rec.x_star, dtype=torch.float64)).abs().max())
        print(f"config 1 battery {name}: outer {d['outer_iters']}, inner {d['inner_iters']}, {d['seconds']:.3f} s, "
              f"f {f:.6e}, |x - x*| {'n/a' if err is None else format(err, '.3e')}, oracle {d['verdict']['ok']}")
        _require(d["converged"] and bool(torch.isfinite(x).all()), f"battery {name}: not converged")
        _require(bool(is_feasible(poly, x[None])[0]), f"battery {name}: polyhedron infeasible")
        _require(cx.numel() == 0 or float(torch.linalg.vector_norm(cx)) < CERT_PIX, f"battery {name}: ||c|| too large")
        _require(rec.f_star is None or f - rec.f_star < 1e-8 + 1e-6 * abs(rec.f_star), f"battery {name}: f = {f} vs f* = {rec.f_star}")
        _require(err is None or err < rec.x_tol, f"battery {name}: |x - x*| = {err} (tol {rec.x_tol})")
        _require(d["verdict"]["ok"], f"battery {name}: the KKT oracle rejects x: {d['verdict']}")
    flagged = sum(bool(d["verdict"].get("degenerate_all_active")) for d in details.values())
    print(f"config 1 battery: {res['battery_oracle_agree']}/{res['battery_oracle_checked']} converged and pass the numpy KKT check "
          f"({flagged} verdicts carry degenerate_all_active), {total:.1f} s in all")
    _require(res["battery_oracle_checked"] == len(REGISTRY) == 18 and not res["battery_oracle_fail"],
             f"battery: failed {res['battery_oracle_fail']}")
    return {"battery_s": total, "slowest": max(details, key=lambda k: details[k]["seconds"]),
            "slowest_s": max(d["seconds"] for d in details.values())}


def _sphere_batch(kern, smi: str) -> dict:
    """Config 1, step 4: the batched nonlinear-constraint path at full width."""
    from benlsip_tpu_torch._batched import tree_map
    from benlsip_tpu_torch.batch import fused_small
    from benlsip_tpu_torch.batch.refine import _cast_problem, solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import sphere_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    B, chunk = 1024, 512
    opts = SolverOptions(max_outer_iter=100, max_inner_iter=300)
    bp, theta, X0 = sphere_family(B, seed=0)   # device=None: the card
    _require(X0.device.type == "cuda", "sphere_family: the default device must be the card")
    out, xs = {}, {}
    # certify="auto" and "host", then the fused path (CUDA-graph replays,
    # device certification); for the fused path the launch counts are those
    # its warm call's replays ran (the fallback refine's launches beside).
    for mode, kw in (("auto", {"certify": "auto"}), ("host", {"certify": "host"}), ("fused", {"fuse": True})):
        run = lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=chunk, **kw)
        kern.reset_launches()
        (X, Y, info), cold = _walled(run)
        launches = dict(kern.LAUNCHES)
        kern.reset_launches()
        fused_small.reset_replay_counts()
        (X2, _, info2), warm = _walled(run)
        if mode == "fused":
            launches = {k: v + kern.LAUNCHES[k] for k, v in fused_small.replay_counts()["launches"].items()}
        ok = info.converged
        n_cert = int(ok.sum())
        tag = f"config 1 sphere_family B={B} {'fuse=True' if mode == 'fused' else 'certify=' + mode}"
        print(f"{tag}: certified {n_cert}/{B}, max pix {float(info.pix[ok].max()):.3e}, max feas {float(info.feas[ok].max()):.3e}, "
              f"cold {cold:.3f} s, warm {warm:.3f} s on {smi}, launches {launches}")
        _require(X.shape == (B, 3) and Y.shape == (B, 1) and X.dtype == torch.float64 and bool(torch.isfinite(X[ok]).all()),
                 f"{tag}: X (B, 3) and Y (B, 1) must be finite float64")
        _require(X.device.type == ("cpu" if mode == "host" else "cuda"), f"{tag}: results on the wrong device")
        _require(n_cert >= 0.9 * B, f"{tag}: only {n_cert}/{B} certified")
        _require(float(info.pix[ok].max()) <= CERT_PIX and float(info.feas[ok].max()) <= CERT_PIX, f"{tag}: a certified lane misses 1.49e-8")
        _require(torch.equal(info2.converged, ok) and float((X2 - X)[ok].abs().max()) <= SMALL_ATOL, f"{tag}: the warm run disagrees with the cold run")
        _check_launched(tag, launches)
        _require(launches["blocked_qr_r"] == 0, f"{tag}: n = 3 has no wide QR")

        # The oracle on 128 sampled certified lanes, the nonlinear block handed over.
        dev = X.device
        th = tree_map(lambda a: a.to(dev), theta)
        fns = bp.instance_fns(th)
        r, J, c, C = (f(X).cpu().numpy() for f in (fns.residuals, fns.jac_res, fns.nlconstraints, fns.jac_nlcons))
        Xn = X.cpu().numpy()
        A, b_rhs, xl, xu = (t.cpu().numpy() for t in (bp.A, bp.b, bp.xl, bp.xu))
        sample = np.random.default_rng(0).choice(np.flatnonzero(ok.cpu().numpy()), size=128, replace=False)
        agree = _oracle_agreement(tag, [(Xn[i], r[i], J[i], c[i], C[i], A, b_rhs, xl, xu) for i in sample])
        _require(agree == 128, f"{tag}: oracle agrees on {agree}/128")
        out[mode] = {"launches": launches, "cold_s": cold, "warm_s": warm, "certified": n_cert}
        xs[mode] = (X.cpu(), ok.cpu())
    for mode in ("host", "fused"):
        both = xs["auto"][1] & xs[mode][1]
        print(f"config 1 sphere_family: {mode} vs certify=auto max |dX| {float((xs[mode][0] - xs['auto'][0])[both].abs().max()):.3e} "
              f"on the {int(both.sum())} lanes certified by both")
    print(f"config 1 sphere_family warm walls on {smi}: certify=auto {out['auto']['warm_s']:.3f} s, certify=host "
          f"{out['host']['warm_s']:.3f} s, fuse=True {out['fused']['warm_s']:.3f} s")

    # The card against the port's CPU run on the first 64 instances.
    first = lambda a: a[:64]
    th_g, X0_g = tree_map(first, theta), X0[:64]
    Xg, _, ig = solve_mixed_precision(bp, th_g, X0_g, opts, chunk=64)
    Xc, _, ic = solve_mixed_precision(_cast_problem(bp, torch.float64, "cpu"), tree_map(lambda a: a.cpu(), th_g), X0_g.cpu(), opts, chunk=64)
    same = torch.equal(ig.converged.cpu(), ic.converged)
    diff = float((Xg.cpu() - Xc)[ic.converged].abs().max())
    print(f"config 1 sphere_family first 64: card vs CPU max |dX| {diff:.3e}, certified {int(ig.converged.sum())}/64 vs {int(ic.converged.sum())}/64")
    _require(same and diff <= SMALL_ATOL, "config 1 first 64: the card's run disagrees with the CPU run")
    return out


def _other_surfaces() -> None:
    """Config 1, step 5: `solve_qp`, `with_inequalities`, `least_squares` once each on the card."""
    from scipy.optimize import least_squares as scipy_least_squares

    from benlsip_tpu_torch import Problem, SolverOptions, least_squares, solve, solve_qp, with_inequalities

    # Box-and-equality QP against a dense KKT solve on the active set the solver found.
    rng = np.random.default_rng(3)
    n, m = 6, 2
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q = (U * np.logspace(0, -np.log10(5.0), n)) @ U.T
    c, A, b = rng.standard_normal(n), rng.standard_normal((m, n)), 0.1 * rng.standard_normal(m)
    lo, hi = -0.4, 0.4
    x, nu, info = solve_qp(Q, c, A, b, xl=lo, xu=hi)
    xh = x.cpu().numpy()
    act = (xh <= lo + 1e-6) | (xh >= hi - 1e-6)
    fr = ~act
    K = np.block([[Q[np.ix_(fr, fr)], A[:, fr].T], [A[:, fr], np.zeros((m, m))]])
    sol = np.linalg.solve(K, np.concatenate([-c[fr] - Q[np.ix_(fr, act)] @ xh[act], b - A[:, act] @ xh[act]]))
    gL = Q @ xh + c + A.T @ sol[fr.sum():]
    print(f"config 1 solve_qp (n=6, m=2, box): converged {bool(info.converged)}, {int(act.sum())} active bounds, "
          f"|x_free - dense KKT| {np.abs(xh[fr] - sol[:fr.sum()]).max():.3e}, |nu - dense KKT| {np.abs(nu.cpu().numpy() - sol[fr.sum():]).max():.3e}, "
          f"stationarity {float(info.stationarity):.3e}")
    _require(x.device.type == "cuda" and bool(info.converged) and np.abs(xh[fr] - sol[:fr.sum()]).max() <= 1e-7
             and np.abs(nu.cpu().numpy() - sol[fr.sum():]).max() <= 1e-6, "solve_qp: disagrees with the dense KKT solve")
    _require(np.all(gL[xh <= lo + 1e-6] >= -1e-6) and np.all(gL[xh >= hi - 1e-6] <= 1e-6) and np.abs(A @ xh - b).max() <= 1e-8,
             "solve_qp: a bound dual has the wrong sign or Ax != b")

    # HS15 through the slack transform: x* = (0.5, 2), f* = 306.5.
    prob = Problem(residuals=lambda x: torch.stack([10 * (x[1] - x[0] ** 2), 1 - x[0]]), xu=[0.5, math.inf])
    lift = with_inequalities(prob, [-2.0, 1.0], nl_ineq=lambda x: torch.stack([x[0] * x[1] - 1.0, x[0] + x[1] ** 2]))
    z, _, info = solve(lift.problem, lift.z0, SolverOptions(max_outer_iter=60, max_inner_iter=200))
    xh = lift.unlift(z).cpu().numpy()
    f = 100 * (xh[1] - xh[0] ** 2) ** 2 + (1 - xh[0]) ** 2
    print(f"config 1 with_inequalities (HS15): x = {xh.tolist()}, f = {f:.9f}, converged {bool(info.converged)}, slacks {lift.slacks(z)[0].tolist()}")
    _require(z.device.type == "cuda" and bool(info.converged) and np.abs(xh - [0.5, 2.0]).max() <= 1e-6 and abs(f - 306.5) <= 1e-7,
             "with_inequalities: HS15 is not at its published optimum")

    # Bounded Rosenbrock against scipy.
    bounds = ([-2.0, -2.0], [0.8, 2.0])
    res = least_squares(lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]), np.array([-1.2, 1.0]), bounds=bounds)
    ref = scipy_least_squares(lambda v: np.array([10.0 * (v[1] - v[0] ** 2), 1.0 - v[0]]), [-1.2, 1.0], bounds=bounds, xtol=1e-15, gtol=1e-12)
    diff = np.abs(res.x.cpu().numpy() - ref.x).max()
    print(f"config 1 least_squares (bounded Rosenbrock): {res}, x = {res.x.tolist()}, |x - scipy| {diff:.3e}, active_mask {res.active_mask.tolist()}")
    _require(res.x.device.type == "cuda" and res.success and res.status > 0 and diff <= 1e-6 and int(res.active_mask[0]) == 1
             and res.optimality < 1.5e-8, "least_squares: disagrees with scipy on the bounded Rosenbrock")


def phase_config1(kern, smi: str) -> dict:
    """Config 1 (a single small problem) and the nonlinear-constraint path,
    through the public entry points; every step raises when its gate fails."""
    res = _single_solves(kern)
    res.update(_classic_battery())
    res.update(_sphere_batch(kern, smi))
    _other_surfaces()
    return res


# Config 4: one large instance, full width (BASELINE config 4, `bench.py:182-272`
# in the JAX package), and the gates `bench.py:223-240` holds it to.
CONFIG4 = dict(n=10240, d=20480, m=8, seed=0, alpha=1.5)
CONFIG4_ORACLE_TOL = 5e-4          # the oracle's stat_tol and feas_tol at f32 grade
CONFIG4_KERNELS = ("masked_aat_cholesky", "project_tangent", "batched_cho_solve")
# The explicit-collective path on a one-rank group against the plain solve:
# the same operations on the same data, so they agree far inside this.
SHARDMAP_ATOL = 1e-5
# The card against the port's CPU run at n = 1024 (f32 to crit_tol 1e-3,
# f64 to 1e-5; at sqrt(eps(f32)) the f32 solve stalls at this size on the
# CPU).  The two runs round differently (cuBLAS against the CPU's BLAS); on
# the CPU a relative change of 1e-7 in x0 moves the solution by 6.4e-5
# (f32) and 3.3e-6 (f64), so the tolerances are 15x and 3x that.
CARD_CPU = {torch.float32: (1e-3, 1e-3), torch.float64: (1e-5, 1e-5)}   # dtype: (crit_tol, atol)


def _config4_oracle(tag: str, bp, theta, x, alpha: float) -> dict:
    """The port's numpy KKT oracle at a config-4 point, in float64 on the host."""
    from benlsip_tpu_torch.baselines.kkt_oracle import kkt_check_point

    xn = x.double().cpu().numpy()
    J0 = theta["J"].cpu().double().numpy()
    r = J0 @ (xn + alpha * xn**3) - theta["y"].cpu().double().numpy()
    J0 *= (1.0 + 3.0 * alpha * xn * xn)[None, :]
    host = lambda t: t.cpu().double().numpy()
    verdict = kkt_check_point(xn, r, J0, None, None, host(bp.A), host(bp.b), host(bp.xl), host(bp.xu),
                              stat_tol=CONFIG4_ORACLE_TOL, feas_tol=CONFIG4_ORACLE_TOL)
    print(f"{tag} oracle (f32 grade, tol {CONFIG4_ORACLE_TOL:g}): {verdict}")
    return verdict


def _info_line(info) -> str:
    return (f"converged {bool(info.converged)}, outer {int(info.outer_iters)}, inner {int(info.inner_iters)}, "
            f"minor {int(info.minor_iters)}, cg {int(info.cg_iters)}, pix {float(info.pix):.3e}")


def phase_config4(kern, profile: bool) -> dict:
    """Config 4 at full size through `dist/sharded.solve_large_blocked_family`
    on a one-rank NCCL mesh: one cold call, two warm calls, the gates of the
    JAX package's bench (converged, the oracle at f32 grade), the operator
    builds and kernel launches of the cold run, peak device memory; then
    the explicit-collective path against it at a reduced size, and the
    card against the port's CPU run at n = 1024."""
    import torch.distributed as dist

    from benlsip_tpu_torch.dist.mesh import make_mesh
    from benlsip_tpu_torch.dist.sharded import solve_large_blocked_family, solve_large_blocked_shardmap
    from benlsip_tpu_torch.problems.generators import blocked_hard_family
    from benlsip_tpu_torch.solver import subproblem
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = torch.device("cuda:0")
    t_phase = time.perf_counter()
    n, d, alpha = CONFIG4["n"], CONFIG4["d"], CONFIG4["alpha"]
    (bp, theta, x0), data_s = _walled(lambda: blocked_hard_family(
        n=n, d=d, m=CONFIG4["m"], seed=CONFIG4["seed"], alpha=alpha, dtype=torch.float32, device=dev))
    mesh = make_mesh(1, 1)
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    _require(dist.get_backend() == "nccl" and float(one) == 1.0, "config 4: the one-rank group must be NCCL")
    opts = SolverOptions(max_outer_iter=20, max_inner_iter=60)
    run = lambda: solve_large_blocked_family(bp, theta, x0, opts, mesh)

    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    subproblem.reset_operator_builds()
    (x, y, info), cold = _walled(run)
    launches = dict(kern.LAUNCHES)
    builds = {f"{fact}/{dt}": k for (fact, dt), k in subproblem.OPERATOR_BUILDS.items()}
    peak = torch.cuda.max_memory_allocated()
    warm = []
    for _ in range(2):
        (x2, _, info2), wall = _walled(run)
        warm.append(wall)
    inner = int(info.inner_iters)
    warm_diff = float((x2 - x).abs().max())
    active = float(((x - bp.xl < 1e-6) | (bp.xu - x < 1e-6)).float().mean())
    print(f"config 4 (n={n}, d={d}, m={CONFIG4['m']}, f32, one-rank NCCL mesh): {_info_line(info)}, "
          f"active fraction {active:.3f}")
    print(f"config 4: data {data_s:.2f} s, cold {cold:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"warm s per inner iteration {min(warm) / max(inner, 1):.4f}, peak device memory {peak / 2**30:.2f} GiB, "
          f"max |dx| warm vs cold {warm_diff:.3e}")
    print(f"config 4: operator builds in the cold run (factorization/dtype: count) = {builds}")
    print(f"config 4: kernel launches in the cold run {launches}")
    _require(x.shape == (n,) and x.dtype == torch.float32 and bool(torch.isfinite(x).all()),
             "config 4: x must be finite float32 of shape (n,)")
    _require(bool(info.converged), "config 4: the solve must converge")
    _require(list(builds) == ["normal/float32"] and builds["normal/float32"] > 0,
             f"config 4: the operator must be the Gram matrix in float32 only, built {builds}")
    _check_launched("config 4", launches, CONFIG4_KERNELS)
    _require(bool(info2.converged) and warm_diff <= SMALL_ATOL,
             "config 4: a warm run disagrees with the cold run")
    verdict = _config4_oracle("config 4", bp, theta, x, alpha)
    _require(bool(verdict["ok"]), "config 4: the KKT oracle rejects the point")

    res = {"launches": launches, "cold_s": cold, "warm_s": warm, "inner": inner, "peak_bytes": peak,
           "data_s": data_s}
    if profile:
        res.update(_profile_config4(run))
    del bp, theta, x0, x, x2
    torch.cuda.empty_cache()

    # The explicit-collective path (spmd_axis="block") on the same one-rank
    # group, every operator layout and reduce schedule, against the plain solve.
    # crit_tol 1e-3: at sqrt(eps(f32)) the f32 solve may stall at this size.
    bp, theta, x0 = blocked_hard_family(n=2048, d=8192, seed=CONFIG4["seed"], dtype=torch.float32, device=dev)
    small = dict(max_outer_iter=20, max_inner_iter=60, crit_tol=1e-3)
    (xr, _, ir), wall = _walled(lambda: solve_large_blocked_family(bp, theta, x0, SolverOptions(**small), mesh))
    print(f"config 4 plain solve (n=2048, d=8192): {_info_line(ir)}, {wall:.3f} s")
    for layout, schedule in (("replicated", "xla"), ("sharded", "xla"), ("sharded", "ring")):
        o = SolverOptions(**small, gram_layout=layout, reduce_schedule=schedule)
        (xs, _, i_s), wall = _walled(lambda: solve_large_blocked_shardmap(bp, theta, x0, o, mesh))
        diff = float((xs - xr).abs().max())
        print(f"config 4 explicit collectives (n=2048, d=8192, {layout}/{schedule}): {_info_line(i_s)}, "
              f"{wall:.3f} s, max |dx| vs the plain solve {diff:.3e}")
        _require(bool(i_s.converged) == bool(ir.converged) and diff <= SHARDMAP_ATOL,
                 f"config 4: the explicit-collective path ({layout}/{schedule}) disagrees with the plain solve")

    # The card against the port's CPU run (plain kernel versions on the CPU).
    for dtype, (crit_tol, atol) in CARD_CPU.items():
        o = SolverOptions(max_outer_iter=20, max_inner_iter=60, crit_tol=crit_tol)
        xs = {}
        for where in ("cpu", "cuda"):
            bp, theta, x0 = blocked_hard_family(n=1024, d=2048, seed=CONFIG4["seed"], dtype=dtype, device=where)
            (xw, _, iw), wall = _walled(lambda: solve_large_blocked_family(bp, theta, x0, o, mesh))
            print(f"config 4 n=1024 {dtype} on {where}: {_info_line(iw)}, {wall:.3f} s")
            _require(bool(iw.converged), f"config 4 n=1024 {dtype} on {where}: not converged")
            xs[where] = xw.cpu()
        diff = float((xs["cpu"] - xs["cuda"]).abs().max())
        print(f"config 4 n=1024 {dtype}: card vs CPU max |dx| {diff:.3e} (tolerance {atol:g})")
        _require(diff <= atol, f"config 4 n=1024 {dtype}: the card's run disagrees with the CPU run")
    dist.destroy_process_group()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"config 4 phase: {res['phase_s']:.1f} s")
    return res


def _profile_config4(run) -> dict:
    """One traced warm config-4 run: device busy share, device kernels, and
    the Gram GEMM (the largest kernel) by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _walled(run)[1]
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"profile config 4: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
          f"({100 * dev_us / 1e6 / wall:.1f}%), {sum(e.count for e in events)} device kernels")
    gemm = [e for e in events if "sgemm" in e.key]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    print(f"profile config 4: Gram GEMM (sgemm kernels) {gemm_us / 1e3:.2f} ms over {sum(e.count for e in gemm)} calls, "
          f"{100 * gemm_us / max(dev_us, 1):.1f}% of device time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile config 4: {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<7d} "
              f"({100 * e.self_device_time_total / max(dev_us, 1):.1f}% of device time) {e.key[:90]}")
    return {"traced_wall_s": wall, "device_busy_s": dev_us / 1e6, "gemm_s": gemm_us / 1e6}


# BASELINE config 5, the 100k-instance sweep, as the JAX package's bench
# runs it (`bench.py:275-326` there): one sweep chunk of 16,384 exponential
# fits, then the sweep of 102,400 in chunks of 16,384 with checkpoints.
CONFIG5 = dict(B=16384, d=32, seed=7, sweep_B=102400, sweep_chunk=16384, stage_outer=2)
CONFIG5_BUDGET_S = 300.0      # the phase's own budget on the card
CONFIG5_TURNS = 5             # warm walls of each route, in turns
CONFIG5_SMALL_B = 4096        # (b)'s batch when (a) + (b) at B would pass the budget
ROUTE_ATOL = 1e-8             # the other routes against the plain route's certified X


def _oracle_exp_fit(tag: str, bp, theta, X, sample: int, seed: int) -> int:
    """The port's numpy KKT oracle on `sample` instances of an exp-fit family
    (shared A, per-instance b), drawn as the JAX package's bench draws them."""
    B = X.shape[0]
    idx = np.random.default_rng(seed).choice(B, size=sample, replace=False)
    it = torch.as_tensor(idx, device=X.device)
    fns = bp.instance_fns({k: v[it] for k, v in theta.items()})
    r, J = fns.residuals(X[it]).cpu().numpy(), fns.jac_res(X[it]).cpu().numpy()
    Xh, A, b_rhs = X[it].cpu().numpy(), bp.A.cpu().numpy(), bp.b[it].cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    return _oracle_agreement(tag, [(Xh[i], r[i], J[i], None, None, A, b_rhs[i], xl, xu) for i in range(sample)])


def phase_config5(kern, smi: str) -> dict:
    """Config 5 (`exp_fit_family(16384, d=32, seed=7)`): (a) the plain,
    compacted (`bulk_compact=2`) and fused routes at full width, gated on
    certification, identity and the oracle, with launches, host syncs and
    warm walls in turns, beside the numpy baseline; (b) the sorted and the
    overlapped routes; (c) the checkpointed 102,400-instance sweep, stopped
    after two chunks and resumed."""
    import tempfile

    from benlsip_tpu_torch import _loops
    from benlsip_tpu_torch.baselines.numpy_ref import solve_exp_fit_numpy
    from benlsip_tpu_torch.batch import compact, fused_small, refine
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.harness.sweep import CheckpointedSweep, run_sweep
    from benlsip_tpu_torch.problems.generators import exp_fit_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    B = CONFIG5["B"]
    (bp, theta, X0), data_s = _walled(lambda: exp_fit_family(B, d=CONFIG5["d"], seed=CONFIG5["seed"],
                                                             dtype=torch.float64, device=dev))
    routes = {"plain": {}, "compact": {"bulk_compact": CONFIG5["stage_outer"]}, "fused": {"fuse": True}}
    call = {name: (lambda kw=kw: solve_mixed_precision(bp, theta, X0, opts, **kw)) for name, kw in routes.items()}

    # (a) Cold plain run with the launches read around it, then the first
    # call of the compacted route and the cold and a warm call of the fused
    # one (which captures its graphs).
    kern.reset_launches()
    (X, Y, info), cold = _walled(call["plain"])
    launches = {"plain": dict(kern.LAUNCHES)}
    _check_certified("config 5 plain", X, info, B, 3)
    _check_launched("config 5", launches["plain"])
    out, first = {"plain": (X, Y, info)}, {"plain": cold}
    kern.reset_launches()
    compact.reset_stats()
    out["compact"], first["compact"] = _walled(call["compact"])
    launches["compact"], stats = dict(kern.LAUNCHES), list(compact.STATS)
    kern.reset_launches()
    fused_small.reset_graph_stats()
    out["fused"], first["fused"] = _walled(call["fused"])
    captured, graphs = dict(kern.CAPTURED), list(fused_small.GRAPH_STATS)
    fused_small.reset_replay_counts()
    out["fused"], fused_warm = _walled(call["fused"])
    executed = fused_small.replay_counts()["launches"]
    for name, (Xr, _, ir) in out.items():
        _check_certified(f"config 5 {name}", Xr, ir, B, 3)
    _check_launched("config 5 compact", launches["compact"])
    for k in PATH_KERNELS:
        _require(captured[k] > 0 and executed[k] > 0,
                 f"config 5 fused: kernel {k} captured {captured[k]}, run by the replays {executed[k]}")
    Xk, Xf = out["compact"][0], out["fused"][0]
    dk, df = float((Xk - X).abs().max()), float((Xf - X).abs().max())
    _require(len(stats) == 1, f"config 5 compact: {len(stats)} compacted bulk solves in one call")
    surv = stats[0]
    print(f"config 5, B={B}: data {data_s:.2f} s; plain cold {cold:.3f} s; compact first {first['compact']:.3f} s; "
          f"fused cold {first['fused']:.3f} s ({len(graphs)} graphs captured: "
          f"{', '.join(f'{g['stage']} {g['capture_s']:.3f}+{g['instantiate_s']:.3f} s' for g in graphs)}), "
          f"fused first warm {fused_warm:.3f} s on {smi}")
    for name, (Xr, _, ir) in out.items():
        print(f"config 5 {name}: certified {int(ir.converged.sum())}/{B}, max pix {float(ir.pix.max()):.3e}")
    print(f"config 5 compact (horizon {CONFIG5['stage_outer']}): {surv['survivors']} of {surv['lanes']} lanes survive "
          f"stage A ({100 * surv['survivors'] / surv['lanes']:.2f}%), in {surv['buckets']} bucket(s); max |dX| against "
          f"the plain route {dk:.3e} ({'identical' if torch.equal(Xk, X) else 'NOT identical'})")
    print(f"config 5 fused: max |dX| against the plain route {df:.3e}")
    print(f"config 5 launches: plain cold {launches['plain']}; compact {launches['compact']}; fused captured "
          f"{captured}, run by a warm call's replays {executed}")
    _require(torch.equal(Xk, X) and torch.equal(out["compact"][2].converged, info.converged),
             f"config 5: compaction's X differs from the plain route's (max |dX| {dk:.3e})")
    _require(torch.allclose(Xf, X, rtol=FUSED_RTOL, atol=FUSED_ATOL),
             f"config 5: the fused route disagrees with the plain route (max |dX| {df:.3e})")
    agree = _oracle_exp_fit("config 5", bp, theta, X, 256, 5)
    _require(agree == 256, f"config 5: oracle agrees on {agree}/256")

    # Warm walls in turns, as many turns as the budget leaves room for
    # beside (b) and (c), estimated from the walls so far (the plain one
    # from its cold call): (b) is about four plain walls (the sorted route
    # takes two), at B=4096 one more plain run there and each a third of the
    # wall at 16,384 (on an H100: 7.5 s against 23.5 s); (c) is about 1.7
    # sweeps of fused chunks (the uninterrupted one, then 2 + 5 chunks).
    # The first turn also counts each route's host syncs.
    est = {"plain": cold, "compact": first["compact"], "fused": fused_warm}
    per_turn = sum(est.values())
    sweep_est = 1.7 * CONFIG5["sweep_B"] / B * est["fused"] + 5.0
    elapsed = time.perf_counter() - t_phase
    small_b = elapsed + CONFIG5_TURNS * per_turn + 4 * est["plain"] + sweep_est > CONFIG5_BUDGET_S
    b_cost = 5 * est["plain"] / 3 if small_b else 4 * est["plain"]
    turns = max(1, min(CONFIG5_TURNS, int((CONFIG5_BUDGET_S - elapsed - b_cost - sweep_est) // per_turn)))
    if turns < CONFIG5_TURNS:
        print(f"config 5: {turns} warm call(s) of each route in turns, not {CONFIG5_TURNS}: the phase's budget of "
              f"{CONFIG5_BUDGET_S:.0f} s leaves no room for more (a turn takes about {per_turn:.1f} s)")
    walls, syncs = {name: [] for name in routes}, {}
    for i in range(turns):
        for name in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
            _loops.reset_host_syncs()
            walls[name].append(_walled(call[name])[1])
            syncs.setdefault(name, _loops.HOST_SYNCS)
    rates = {}
    for name, w in walls.items():
        med = float(np.median(w))
        rates[name] = B / med
        print(f"config 5 {name}: warm wall ({len(w)} in turns) median {med:.4f} s, range {min(w):.4f}-{max(w):.4f} s, "
              f"all {[round(x, 4) for x in w]}; {rates[name]:.1f} certified instances/s; host syncs per warm call "
              f"{syncs[name]} on {smi}")

    # The single-core numpy baseline on the first 64 instances.
    k = 64
    th_np = {key: v[:k].cpu().numpy() for key, v in theta.items()}
    t0 = time.perf_counter()
    _, conv_np = solve_exp_fit_numpy(th_np["t"], th_np["y"], bp.A.cpu().numpy(), bp.b[:k].cpu().numpy(),
                                     bp.xl.cpu().numpy(), bp.xu.cpu().numpy(), X0[:k].cpu().numpy())
    np_wall = time.perf_counter() - t0
    np_rate = max(conv_np, 1) / np_wall
    print(f"config 5 numpy baseline (one core, first {k} instances): {conv_np}/{k} converged in {np_wall:.3f} s, "
          f"{np_rate:.1f} instances/s; plain / compact / fused over it: "
          f"{rates['plain'] / np_rate:.1f}x / {rates['compact'] / np_rate:.1f}x / {rates['fused'] / np_rate:.1f}x")

    # (b) The sorted and the overlapped routes, once each, against the
    # plain route (certify="auto", on the card) on the same data.
    Bb = CONFIG5_SMALL_B if small_b else B
    if small_b:
        print(f"config 5 (b): at B={Bb}, not {B}: (a) + (b) at B={B} would pass the phase's budget")
        bp_b, th_b, X0_b = exp_fit_family(Bb, d=CONFIG5["d"], seed=CONFIG5["seed"], dtype=torch.float64, device=dev)
        (Xb, _, ib), plain_b = _walled(lambda: solve_mixed_precision(bp_b, th_b, X0_b, opts))
        _check_certified("config 5 (b) plain", Xb, ib, Bb, 3)
    else:
        bp_b, th_b, X0_b, Xb, plain_b = bp, theta, X0, X, float(np.median(walls["plain"]))
    other = {"sorted": {"sort_by_difficulty": True}, "overlap host": {"pipeline_overlap": True, "certify": "host"},
             "overlap device": {"pipeline_overlap": True, "certify": "device"}}
    res_b = {}
    for name, kw in other.items():
        (Xo, _, io), wall = _walled(lambda: solve_mixed_precision(bp_b, th_b, X0_b, opts, **kw))
        _check_certified(f"config 5 {name}", Xo, io, Bb, 3)
        d = float((Xo.to(dev) - Xb).abs().max())
        line = (f"config 5 {name} (B={Bb}): certified {int(io.converged.sum())}/{Bb}, wall {wall:.3f} s beside the plain "
                f"route's {plain_b:.3f} s, max |dX| against it {d:.3e}")
        if "overlap" in name:
            st = dict(refine.OVERLAP_STAGES)
            line += (f"; its stages: bulk {st['bulk_s']:.3f} s (main thread) + certification {st['certify_s']:.3f} s "
                     f"(worker) = {st['bulk_s'] + st['certify_s']:.3f} s, overlap wall {st['wall_s']:.3f} s")
            res_b[name + " stages"] = st
        print(line + f" on {smi}")
        _require(d <= ROUTE_ATOL, f"config 5 {name}: X differs from the plain route's by {d:.3e} (> {ROUTE_ATOL:g})")
        res_b[name] = wall
    res_b["plain"], res_b["B"] = plain_b, Bb

    # (c) The 102,400-instance sweep in chunks of 16,384 through the fused
    # route, checkpointed; then the same sweep stopped after two chunks and
    # resumed, which must give the same bits.
    SB, SC = CONFIG5["sweep_B"], CONFIG5["sweep_chunk"]
    del bp_b, th_b, X0_b
    bp_s, th_s, X0_s = exp_fit_family(SB, d=CONFIG5["d"], seed=CONFIG5["seed"], dtype=torch.float64, device=dev)
    kw = dict(sweep_chunk=SC, pipeline_kwargs={"fuse": True})
    with tempfile.TemporaryDirectory() as tmp:
        Xs, Ys, i_s, resumed0, sweep_wall = run_sweep(bp_s, th_s, X0_s, opts, tmp + "/full", **kw)
        step_bytes = os.path.getsize(os.path.join(tmp, "full", os.listdir(tmp + "/full")[0]))
        stopped = CheckpointedSweep(bp_s, opts, tmp + "/stopped", **kw)
        t0 = time.perf_counter()
        try:
            stopped.run(th_s, X0_s, stop_after_chunks=2)
            raise AssertionError("config 5 sweep: stop_after_chunks=2 did not stop the sweep")
        except RuntimeError as e:
            if "rerun to resume" not in str(e):
                raise
        Xr, Yr, ir_, resumed = CheckpointedSweep(bp_s, opts, tmp + "/stopped", **kw).run(th_s, X0_s)
        resume_wall = time.perf_counter() - t0
    n_cert = int(i_s.converged.sum())
    same = torch.equal(Xr, Xs) and torch.equal(Yr, Ys) and all(torch.equal(a, b) for a, b in zip(ir_, i_s))
    print(f"config 5 sweep (B={SB}, sweep_chunk={SC}, fuse=True, checkpointed): certified {n_cert}/{SB}, max pix "
          f"{float(i_s.pix.max()):.3e}, wall {sweep_wall:.3f} s, {n_cert / sweep_wall:.1f} certified instances/s, "
          f"checkpoint {step_bytes} bytes per step on {smi}")
    print(f"config 5 sweep stopped after 2 chunks and resumed: resumed_from {resumed}, "
          f"{resume_wall:.3f} s in all, bitwise equal to the uninterrupted sweep: {same}")
    _require(Xs.shape == (SB, 3) and Xs.device.type == "cpu" and resumed0 == 0, "config 5 sweep: bad result")
    _require(n_cert == SB and float(i_s.pix.max()) <= CERT_PIX, f"config 5 sweep: {n_cert}/{SB} certified")
    _require(resumed == 2 and same, f"config 5 sweep: resumed_from {resumed}, bitwise equal {same}")

    res = {"launches": launches["plain"], "launches_compact": launches["compact"], "captured": captured,
           "executed": executed, "cold_s": cold, "walls": walls, "syncs": syncs, "survivors": surv,
           "numpy_rate": np_rate, "b": res_b, "sweep_s": sweep_wall, "step_bytes": step_bytes}
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"config 5 phase: {res['phase_s']:.1f} s")
    return res


def phase_profile(kern) -> None:
    """Where the warm time of each path goes: bulk vs certification wall,
    and the device's busy share from torch.profiler (sum of kernel times
    over the host wall of one warm run); how many device kernels one
    call of each fused kernel, and of the call site it replaces, launches;
    and the panel QR kernel's time against the column count and the batch."""
    from torch.profiler import ProfilerActivity, profile

    from benlsip_tpu_torch.batch.polish import sqp_polish_fused
    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family, exp_fit_family, sphere_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = torch.device("cuda:0")

    def device_kernels(fn) -> int:
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _walled(fn)
        return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)

    rng = np.random.default_rng(1)
    for B, m, n, shared in ((512, 1, 3, False), (64, 6, 192, True)):
        A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        L = kern.masked_aat_cholesky(A, fixed, 1e-3)
        counts = {
            "masked_aat_cholesky": device_kernels(lambda: kern.masked_aat_cholesky(A, fixed)),
            "old factor site": device_kernels(lambda: old_factor_site(kern, A, fixed)),
            "project_tangent": device_kernels(lambda: kern.project_tangent(A, L, fixed, r)),
            "old projection site": device_kernels(lambda: old_project_site(kern, A, L, fixed, r)),
        }
        print(f"profile call sites {B}x{m}x{n}{' shared A' if shared else ''}: device kernels per call {counts}")

    # The panel QR kernel's time against the column count and the batch:
    # t(N = 32) is one panel (its load and the Gram-Schmidt steps inside
    # it), t(64) − 2·t(32) one projection against a finished panel, and one
    # instance against 64 says whether latency or throughput sets the time.
    scan = {}
    for B, D, N in ((64, 1216, 32), (64, 1216, 64), (64, 1216, 192), (1, 1216, 192), (132, 1216, 192)):
        S = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
        scan[f"{B}x{D}x{N}"] = round(_cuda_ms(lambda: kern.blocked_qr_r(S), reps=30, warm=3), 4)
    print(f"profile blocked_qr_r: ms by shape {scan}")

    paths = {
        "config 2": (exp_fit_family(1024, d=32, seed=42, dtype=torch.float64, device=dev),
                     dict(max_outer_iter=40, max_inner_iter=120), 8, 512),
        "config 3": (dense_quadratic_family(64, n=192, d=1024, m=6, seed=3, dtype=torch.float64, device=dev),
                     dict(max_outer_iter=30, max_inner_iter=100), 100, 64),
        "config 1": (sphere_family(1024, seed=0, dtype=torch.float64, device=dev),
                     dict(max_outer_iter=100, max_inner_iter=300), 8, 512),
        "config 5": (exp_fit_family(CONFIG5["B"], d=CONFIG5["d"], seed=CONFIG5["seed"], dtype=torch.float64, device=dev),
                     dict(max_outer_iter=40, max_inner_iter=120), 8, 512),
    }
    for tag, ((bp, theta, X0), caps, bulk_inner, chunk) in paths.items():
        opts = SolverOptions(**caps)
        bulk_opts = SolverOptions(max_outer_iter=caps["max_outer_iter"], max_inner_iter=bulk_inner, crit_tol=1e-2)
        bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(theta, torch.float32)
        walls = {}
        for name, fn in (
            ("bulk", lambda: solve_batched_chunked(bp32, th32, X0.float(), bulk_opts, chunk=chunk)),
            ("pipeline", lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=chunk)),
        ):
            fn()
            walls[name] = _walled(fn)[1]
        print(f"profile {tag}: warm wall bulk {walls['bulk']:.3f} s, "
              f"certification {walls['pipeline'] - walls['bulk']:.3f} s, pipeline {walls['pipeline']:.3f} s")
        # How far the polish alone certifies the bulk's points: the first
        # fused polish (rounds=1), then with the re-polish buckets (rounds=2);
        # the pipeline hands the lanes left over to the full f64 refine.
        X32 = solve_batched_chunked(bp32, th32, X0.float(), bulk_opts, chunk=chunk)[0]
        bp64, th64 = _cast_problem(bp, torch.float64, dev), _cast_tree(theta, torch.float64)
        for rounds in (1, 2):
            out, wall = _walled(lambda: sqp_polish_fused(bp32, th32, X32, bp64, th64, opts, num_steps=5, rounds=rounds))
            print(f"profile {tag}: fused polish, rounds={rounds}: certifies {int(out[2].sum())}/{X32.shape[0]} lanes in {wall:.3f} s")
        for _ in range(2):   # two traced runs: the counts should repeat
            # Device activity only: the host's events are read nowhere here, and a
            # config-1 run has millions of them.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall = _walled(lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=chunk))[1]
            events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_us = sum(e.self_device_time_total for e in events)
            n_launch = sum(e.count for e in events)
            print(f"profile {tag}: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
                  f"({100 * dev_us / 1e6 / wall:.1f}%), {n_launch} device kernels "
                  f"(before the panel QR kernel: {DEVICE_KERNELS_BEFORE.get(tag, 'not measured')})")
            for pattern in ("geqr2", "blocked_qr_r"):
                hits = [e for e in events if pattern in e.key]
                print(f"profile {tag}: {pattern}*: {sum(e.self_device_time_total for e in hits) / 1e3:.2f} ms "
                      f"over {sum(e.count for e in hits)} calls")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"profile {tag}: {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<7d} {e.key[:90]}")
        if tag == "config 5":
            # The compacted route: its bulk alone (stage A, then the
            # survivor buckets) and one traced pipeline run.
            from benlsip_tpu_torch.batch.compact import solve_batched_compact

            fn = lambda: solve_batched_compact(bp32, th32, X0.float(), bulk_opts, chunk=chunk,
                                               stage_outer=CONFIG5["stage_outer"])
            fn()
            print(f"profile config 5 compact: warm wall bulk {_walled(fn)[1]:.3f} s")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall = _walled(lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=chunk,
                                                             bulk_compact=CONFIG5["stage_outer"]))[1]
            events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_us = sum(e.self_device_time_total for e in events)
            print(f"profile config 5 compact: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
                  f"({100 * dev_us / 1e6 / wall:.1f}%), {sum(e.count for e in events)} device kernels")


def main() -> None:
    smi = phase_card()   # raises without a CUDA device, before any output
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    print(f"card: {smi}")
    phase_build(kern)
    rec = phase_kernels(kern)
    res = phase_slice(kern)
    resf = phase_fused(kern, smi, "--profile" in sys.argv[1:])
    res3 = phase_config3(kern)
    res1 = phase_config1(kern, smi)
    res4 = phase_config4(kern, "--profile" in sys.argv[1:])
    res5 = phase_config5(kern, smi)
    if "--profile" in sys.argv[1:]:
        phase_profile(kern)
    src = "benlsip_tpu_torch/kernels/csrc/"
    sources = {
        "batched_cholesky": (src + "cholesky.cu", "benlsip_tpu/kernels/batched_linalg.py:74"),
        "batched_cho_solve": (src + "cho_solve.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "batched_thin_qr": (src + "thin_qr.cu", "benlsip_tpu/kernels/batched_linalg.py:170"),
        "masked_aat_cholesky": (src + "masked_aat_cholesky.cu", "benlsip_tpu/kernels/batched_linalg.py:74"),
        "project_tangent": (src + "project_tangent.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "blocked_qr_r": (src + "blocked_qr.cu", "benlsip_tpu/kernels/batched_linalg.py:170"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        k = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        own2, own3 = res["launches"][name], res3["launches"][name]
        own1, own1_b1 = res1["auto"]["launches"][name], res1["launches_b1"][name]
        if name == "batched_cholesky":
            # Its body runs on every path inside masked_aat_cholesky, whose
            # record holds those launches; its own wrapper is behind
            # ops/cholesky.cholesky, which no path calls now.
            k["on_path_as"] = "masked_aat_cholesky"
        if name == "blocked_qr_r":
            # Configs 1 and 2 (n = 3) have no wide QR and launch it 0 times.
            k["launches_config3_host"] = res3["launches_host"][name]
        own4, own5 = res4["launches"][name], res5["launches"][name]
        k.update({"launches": own2 + own3 + own1 + own1_b1 + own4 + own5, "launches_config2": own2,
                  "launches_config3": own3,
                  "launches_config1": own1, "launches_config1_host": res1["host"]["launches"][name],
                  "launches_config1_single_f32": own1_b1, "launches_config4": own4,
                  # Config 5: the plain route's cold run, the compacted route's
                  # first call, and the fused route as config 2's fused path.
                  "launches_config5": own5, "launches_config5_compact": res5["launches_compact"][name],
                  "captured_config5_fused": res5["captured"][name],
                  "launches_config5_fused": res5["executed"][name],
                  # The fused paths run as CUDA-graph replays: launches captured into their
                  # graphs in the cold call, and the launches a warm call's replays ran
                  # (a WHILE body's captured launches times its loop's trips; for
                  # config 1 with the eager fallback refine's).
                  "captured_config2_fused": resf["captured"][name],
                  "launches_config2_fused": resf["executed"][name],
                  "launches_config1_fused": res1["fused"]["launches"][name], **rec[name]})
        kernels.append(k)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
