"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 is off;
2. build the CUDA kernels of benlsip_tpu_torch from csrc/ (nvcc, sm_90a);
3. each of the six kernels against its plain PyTorch version on the card,
   in float32, at both paths' shapes and the kernel tests' shapes, with
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
6. with `--profile` only: each path's warm wall split into bulk and
   certification, and the device's busy share and kernel count from
   torch.profiler, with the time and calls of cuSOLVER's `geqr2*` and of
   the panel QR kernel.

It imports nothing of JAX and nothing of the JAX package: the KKT oracle
is the port's own copy.  The last two lines are the kernels' JSON record
(launch counts per path, times, bounds) and the result JSON.
"""
from __future__ import annotations

import json
import math
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
CONFIG3_KERNELS = PATH_KERNELS + ("blocked_qr_r",)
# Device kernels of one warm run before the panel QR kernel (H100 80GB HBM3, 700 W).
DEVICE_KERNELS_BEFORE = {"config 2": "68,888-68,892", "config 3": "17,405-17,413"}
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

    for B, M in ((1024, 1), (1024, 2), (1024, 3), (1024, 5), (64, 6), (1024, 8), (1024, 16)):
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

    for B, D, N in ((1024, 35, 3), (1024, 3, 1), (64, 192, 6), (200, 32, 3), (140, 16, 8)):
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
    for B, m, n, shared in cases:
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
    W = torch.as_tensor(rng.standard_normal((1024, 3, 1)), dtype=f32, device=dev)
    t = _in_turns({"plain": lambda: kern.batched_thin_qr_plain(W), "kernel": lambda: kern.batched_thin_qr(W),
                   "library": lambda: torch.linalg.qr(W, mode="reduced")})
    bound = _qr_bound(*W.shape)
    rec["batched_thin_qr"].update({"ms_1024x3x1": t["kernel"], "plain_ms_1024x3x1": t["plain"],
                                   "library_ms_1024x3x1": t["library"], "bound_us_1024x3x1": bound["bound_us"]})
    print(f"batched_thin_qr 1024x3x1: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, library {t['library']:.4f} ms, "
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
    bp_s, th_s, X0_s = exp_fit_family(64, d=32, seed=42, dtype=torch.float64)
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

    bp_c, th_c, X0_c = dense_quadratic_family(8, n=n, d=d, m=m, seed=3, dtype=torch.float64)
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


def phase_profile(kern) -> None:
    """Where the warm time of each path goes: bulk vs certification wall,
    and the device's busy share from torch.profiler (sum of kernel times
    over the host wall of one warm run); how many device kernels one
    call of each fused kernel, and of the call site it replaces, launches;
    and the panel QR kernel's time against the column count and the batch."""
    from torch.profiler import ProfilerActivity, profile

    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree, solve_mixed_precision
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family, exp_fit_family
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
        for _ in range(2):   # two traced runs: the counts should repeat
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = _walled(lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=chunk))[1]
            events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_us = sum(e.self_device_time_total for e in events)
            n_launch = sum(e.count for e in events)
            print(f"profile {tag}: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
                  f"({100 * dev_us / 1e6 / wall:.1f}%), {n_launch} device kernels "
                  f"(before the panel QR kernel: {DEVICE_KERNELS_BEFORE[tag]})")
            for pattern in ("geqr2", "blocked_qr_r"):
                hits = [e for e in events if pattern in e.key]
                print(f"profile {tag}: {pattern}*: {sum(e.self_device_time_total for e in hits) / 1e3:.2f} ms "
                      f"over {sum(e.count for e in hits)} calls")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"profile {tag}: {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<7d} {e.key[:90]}")


def main() -> None:
    smi = phase_card()   # raises without a CUDA device, before any output
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    print(f"card: {smi}")
    phase_build(kern)
    rec = phase_kernels(kern)
    res = phase_slice(kern)
    res3 = phase_config3(kern)
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
        if name == "batched_cholesky":
            # Its body runs on both paths inside masked_aat_cholesky, whose
            # record holds those launches; its own wrapper is behind
            # ops/cholesky.cholesky, which no path calls now.
            k["on_path_as"] = "masked_aat_cholesky"
        if name == "blocked_qr_r":
            # Config 2 (n = 3) has no wide QR and launches it 0 times.
            k["launches_config3_host"] = res3["launches_host"][name]
        k.update({"launches": own2 + own3, "launches_config2": own2, "launches_config3": own3, **rec[name]})
        kernels.append(k)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
