"""Hand-written Hopper kernels for batched small-matrix linear algebra.

CUDA C++ twins of the three Pallas TPU kernels of
`benlsip_tpu/kernels/batched_linalg.py`:

* `batched_cholesky`  ← `batched_cholesky` / `_cholesky_kernel`  (:44, :74)
* `batched_cho_solve` ← `batched_cho_solve` / `_cho_solve_kernel` (:101, :119)
* `batched_thin_qr`   ← `batched_thin_qr` / `_mgs_qr_kernel`     (:147, :170)

Each wrapper keeps the JAX package's public layout — (B, M, M), (B, M) and
(B, D, N), row-major — and none of the TPU's batch-last transposes or lane
padding.  On a CUDA tensor it launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, which computes the
same algorithm in the same order with batched torch ops.  There is no
fallback from a failed build or launch to the plain version.

The sources in `csrc/` are compiled with nvcc for sm_90a into one shared
library with a plain C interface on first use, into `_build/` keyed on a
hash of the sources and flags, and loaded with ctypes.  Each wrapper adds
one to its entry of `LAUNCHES` when it launches its kernel, and nowhere
else, so a run can show that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

Tensor = torch.Tensor

MAX_DIM = 16        # largest M (Cholesky, solve) and N (QR) the kernels take
MAX_QR_ROWS = 2048  # largest D the QR kernel takes (the JAX gate's bound)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: the NaN-on-non-SPD contract needs IEEE sqrt.
# --fmad=false keeps every multiply and add separately rounded, as the
# plain versions' elementwise torch ops are.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"batched_cholesky": 0, "batched_cho_solve": 0, "batched_thin_qr": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbenlsip_kernels_{h.hexdigest()[:16]}.so"


_SIGNATURES = {
    "benlsip_cholesky": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "benlsip_cho_solve": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "benlsip_thin_qr": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def build() -> Path:
    """Compile `csrc/*.cu` with nvcc if the library for these sources is missing.

    The ptxas report (registers, spills per kernel) is kept beside the
    library as `<name>.log`.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.benlsip_error_string.argtypes = [ctypes.c_int]
    lib.benlsip_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, base: str, t: Tensor, *args) -> None:
    lib = load_library()
    fn = getattr(lib, f"{base}_{'f32' if t.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = lib.benlsip_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES[name] += 1


def _require_cuda(name: str, *ts: Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}; the kernel runs on CUDA tensors only")
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(f"{name}: bf16 is not ported yet")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {t.dtype} (the kernel takes float32 or float64)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel needs contiguous row-major tensors")
    if any(t.dtype != ts[0].dtype or t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: all tensors must share dtype and device")


def _on_cpu(t: Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"tensor on {t.device}: only cpu (plain version) and cuda (kernel)")
    return False


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------


def batched_cholesky_plain(K: Tensor) -> Tensor:
    """Plain PyTorch twin of the Cholesky kernel: unrolled
    Cholesky–Banachiewicz over the batch, no pivot clamping (NaN on a
    non-SPD pivot)."""
    B, M, _ = K.shape
    col = [[None] * M for _ in range(M)]
    for j in range(M):
        acc = K[:, j, j]
        for k in range(j):
            acc = acc - col[j][k] * col[j][k]
        d = torch.sqrt(acc)
        col[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, M):
            s = K[:, i, j]
            for k in range(j):
                s = s - col[i][k] * col[j][k]
            col[i][j] = s * inv_d
    L = torch.zeros_like(K)
    for i in range(M):
        for j in range(i + 1):
            L[:, i, j] = col[i][j]
    return L


def batched_cholesky(K: Tensor) -> Tensor:
    """Lower Cholesky factors of a batch of SPD matrices: K (B, M, M) -> L."""
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"batched_cholesky: expected (B, M, M), got {tuple(K.shape)}")
    B, M, _ = K.shape
    if B == 0 or M == 0:
        return torch.zeros_like(K)
    if _on_cpu(K):
        return batched_cholesky_plain(K)
    _require_cuda("batched_cholesky", K)
    if M > MAX_DIM:
        raise ValueError(f"batched_cholesky: M={M} > {MAX_DIM}")
    L = torch.empty_like(K)
    _launch("batched_cholesky", "benlsip_cholesky", K, K.data_ptr(), L.data_ptr(), B, M)
    return L


# ---------------------------------------------------------------------------
# Cholesky solve
# ---------------------------------------------------------------------------


def batched_cho_solve_plain(L: Tensor, b: Tensor) -> Tensor:
    """Plain PyTorch twin of the solve kernel: unrolled forward then
    backward substitution for L Lᵀ x = b."""
    M = L.shape[-1]
    y = [None] * M
    for i in range(M):
        acc = b[:, i]
        for k in range(i):
            acc = acc - L[:, i, k] * y[k]
        y[i] = acc / L[:, i, i]
    x = [None] * M
    for i in reversed(range(M)):
        acc = y[i]
        for k in range(i + 1, M):
            acc = acc - L[:, k, i] * x[k]
        x[i] = acc / L[:, i, i]
    return torch.stack(x, dim=1)


def batched_cho_solve(L: Tensor, b: Tensor) -> Tensor:
    """Solve L Lᵀ x = b for a batch: L (B, M, M), b (B, M) -> x (B, M)."""
    if L.ndim != 3 or L.shape[1] != L.shape[2] or b.shape != L.shape[:2]:
        raise ValueError(
            f"batched_cho_solve: expected (B, M, M) and (B, M), got {tuple(L.shape)}, {tuple(b.shape)}"
        )
    B, M, _ = L.shape
    if B == 0 or M == 0:
        return torch.zeros_like(b)
    if _on_cpu(L):
        return batched_cho_solve_plain(L, b)
    _require_cuda("batched_cho_solve", L, b)
    if M > MAX_DIM:
        raise ValueError(f"batched_cho_solve: M={M} > {MAX_DIM}")
    x = torch.empty_like(b)
    _launch("batched_cho_solve", "benlsip_cho_solve", L, L.data_ptr(), b.data_ptr(), x.data_ptr(), B, M)
    return x


# ---------------------------------------------------------------------------
# Thin QR (modified Gram–Schmidt)
# ---------------------------------------------------------------------------


def batched_thin_qr_plain(A: Tensor):
    """Plain PyTorch twin of the MGS QR kernel: column-by-column modified
    Gram–Schmidt with the column norm floored at finfo.tiny."""
    B, D, N = A.shape
    tiny = torch.finfo(A.dtype).tiny
    R = torch.zeros((B, N, N), dtype=A.dtype, device=A.device)
    q = []
    for j in range(N):
        v = A[:, :, j]
        for k in range(j):
            rkj = (q[k] * v).sum(-1)
            R[:, k, j] = rkj
            v = v - q[k] * rkj[:, None]
        nrm = torch.sqrt(torch.clamp_min((v * v).sum(-1), tiny))
        R[:, j, j] = nrm
        q.append(v / nrm[:, None])
    return torch.stack(q, dim=2), R


def batched_thin_qr(A: Tensor):
    """Thin QR of a batch: A (B, D, N) -> (Q (B, D, N), R (B, N, N))."""
    if A.ndim != 3:
        raise ValueError(f"batched_thin_qr: expected (B, D, N), got {tuple(A.shape)}")
    B, D, N = A.shape
    if B == 0 or N == 0:
        return torch.zeros_like(A), torch.zeros((B, N, N), dtype=A.dtype, device=A.device)
    if _on_cpu(A):
        return batched_thin_qr_plain(A)
    _require_cuda("batched_thin_qr", A)
    if not (N <= MAX_DIM and N <= D <= MAX_QR_ROWS):
        raise ValueError(f"batched_thin_qr: need N <= {MAX_DIM} and N <= D <= {MAX_QR_ROWS}, got D={D}, N={N}")
    Q = torch.empty_like(A)
    R = torch.empty((B, N, N), dtype=A.dtype, device=A.device)
    _launch("batched_thin_qr", "benlsip_thin_qr", A, A.data_ptr(), Q.data_ptr(), R.data_ptr(), B, D, N)
    return Q, R
