"""Hand-written Hopper kernels for batched small-matrix linear algebra.

CUDA C++ twins of the three Pallas TPU kernels of
`benlsip_tpu/kernels/batched_linalg.py`:

* `batched_cholesky`  ← `batched_cholesky` / `_cholesky_kernel`  (:44, :74)
* `batched_cho_solve` ← `batched_cho_solve` / `_cho_solve_kernel` (:101, :119)
* `batched_thin_qr`   ← `batched_thin_qr` / `_mgs_qr_kernel`     (:147, :170)

and the three kernels that redesign them for this card:

* `masked_aat_cholesky`: L = chol(A Z Aᵀ + reg·I), the Cholesky kernel
  with the masked Gram product in front of it, one launch per call site;
* `project_tangent`: Z r − Z Aᵀ (L Lᵀ)⁻¹ A Z r, the solve kernel with
  the mask and both products with A around it, one launch per call site;
* `blocked_qr_r`: the R factor of wide tall matrices (16 < N), a panel
  QR in shared memory, one thread block per instance, where the TPU
  kernel's gate left the factorization to the library.

Each wrapper keeps the JAX package's public layout — (B, M, M), (B, M) and
(B, D, N), row-major — and none of the TPU's batch-last transposes or lane
padding.  On a CUDA tensor it launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, which computes the
same algorithm in the same order with batched torch ops.  There is no
fallback from a failed build or launch to the plain version.

The sources in `csrc/` are compiled with nvcc for sm_90a (one nvcc per
source, all started together) and linked into one shared
library with a plain C interface on first use, into `_build/` keyed on a
hash of the sources and flags, and loaded with ctypes.  Each wrapper adds
one to its entry of `LAUNCHES` when it launches its kernel, and nowhere
else, so a run can show that the main path went through the kernels.

A wrapper called inside a CUDA graph capture records its kernel into the
graph instead (`_launch` is stream-ordered, allocates nothing itself, and
the kernels call only `cudaGetLastError` and `cudaFuncSetAttribute`): it
adds one to `CAPTURED`, not to `LAUNCHES`.  What the replays run is
counted by the graphs' owner (`batch/fused_small.replay_counts`: captured
launches of each WHILE body times the trips its loop ran).  The library
must be built and loaded before a capture; a first load inside one raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

Tensor = torch.Tensor

MAX_DIM = 16        # largest M (Cholesky, solve) and N (QR) the kernels take
MAX_QR_ROWS = 2048  # largest D the QR kernels take (the JAX gate's bound)
# The panel QR kernel behind `ops/qr.qr_r`: as many columns as it is measured
# against the library call, and as few instances as it still beats it with
# (one thread block factors one instance, the library gives each the card).
MAX_BLOCKED_QR_COLS = 256
MIN_BLOCKED_QR_BATCH = 4
QR_PANEL_WIDTHS = (32, 16, 8)    # the panel QR kernel's instantiations, widest first
QR_BLOCK_WARPS = 8               # warps of one block of the panel QR kernel
MAX_DYNAMIC_SMEM = 232448        # bytes of shared memory a block may opt in to on sm_90

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: the NaN-on-non-SPD contract needs IEEE sqrt.
# --fmad=false keeps every multiply and add separately rounded, as the
# plain versions' elementwise torch ops are.  The panel QR sums in another
# order than its plain version's matrix products whatever the rounding, so
# it alone keeps the fused multiply-add (twice the rate).
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
FMAD_SOURCES = ("blocked_qr.cu",)

LAUNCHES = {
    "batched_cholesky": 0, "batched_cho_solve": 0, "batched_thin_qr": 0,
    "masked_aat_cholesky": 0, "project_tangent": 0, "blocked_qr_r": 0,
}
CAPTURED = dict.fromkeys(LAUNCHES, 0)   # launches recorded into CUDA graphs
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch and capture count to 0."""
    for counts in (LAUNCHES, CAPTURED):
        for k in counts:
            counts[k] = 0


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
    h = hashlib.sha256(repr((NVCC_FLAGS, FMAD_SOURCES)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbenlsip_kernels_{h.hexdigest()[:16]}.so"


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "benlsip_cholesky": [_PTR, _PTR, _INT, _INT, _PTR],
    "benlsip_cho_solve": [_PTR] * 3 + [_INT, _INT, _PTR],
    "benlsip_thin_qr": [_PTR] * 3 + [_INT] * 3 + [_PTR],
    # A, its batch stride, fixed, reg, L, B, M, n, stream
    "benlsip_masked_aat_cholesky": [_PTR, ctypes.c_longlong, _PTR, ctypes.c_double, _PTR] + [_INT] * 3 + [_PTR],
    # A, its batch stride, L, fixed, r, out, B, M, n, unmasked_output, stream
    "benlsip_project_tangent": [_PTR, ctypes.c_longlong] + [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # S, R, workspace, B, D, N, panel width, leading dimension, stream
    "benlsip_blocked_qr_r": [_PTR] * 3 + [_INT] * 5 + [_PTR],
}


def build() -> Path:
    """Compile `csrc/*.cu` with nvcc if the library for these sources is missing:
    one nvcc per source, all started together, then one link.

    The ptxas report (registers, spills per kernel) is kept beside the
    library as `<name>.log`.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            fmad = f"--fmad={'true' if src.name in FMAD_SOURCES else 'false'}"
            cmd = [nvcc, *NVCC_FLAGS, fmad, "-c", str(src), "-o", str(Path(tmp) / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        link = [nvcc, *NVCC_ARCH, "-shared", "-o", str(Path(tmp) / out.name), *[cmd[-1] for cmd, _ in jobs]]
        report, failed = [], []
        for cmd, proc in jobs:   # wait for every compile, so none outlives a failure
            stdout, stderr = proc.communicate()
            report.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stderr}")
        out.with_suffix(".log").write_text("".join(report))
        os.replace(Path(tmp) / out.name, out)
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
    # The conditional WHILE nodes of graph capture (`csrc/graph_conditional.cu`).
    lib.benlsip_while_begin.argtypes = [_PTR, _PTR, _PTR, ctypes.POINTER(ctypes.c_ulonglong),
                                        ctypes.POINTER(ctypes.c_void_p)]
    lib.benlsip_while_set.argtypes = [ctypes.c_ulonglong, _PTR, _PTR]
    lib.benlsip_while_end.argtypes = [_PTR]
    for fn in (lib.benlsip_while_begin, lib.benlsip_while_set, lib.benlsip_while_end):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {load_library().benlsip_error_string(rc).decode()} (cudaError {rc})")


def while_begin(pred: Tensor, parent: torch.cuda.Stream, body: torch.cuda.Stream) -> tuple:
    """In the graph being captured on `parent`, add a WHILE node that runs
    while its handle is set, set it from the bool `pred` (a 0-dim CUDA
    tensor), and start capturing `body` into the node's body; returns the
    handle and the body graph (a cudaGraph_t)."""
    handle, graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    _check(load_library().benlsip_while_begin(pred.data_ptr(), parent.cuda_stream, body.cuda_stream,
                                              ctypes.byref(handle), ctypes.byref(graph)), "while_begin")
    return handle.value, graph.value


def while_set(handle: int, pred: Tensor, stream: torch.cuda.Stream) -> None:
    """Capture on `stream` the kernel that sets `handle` from `pred`."""
    _check(load_library().benlsip_while_set(handle, pred.data_ptr(), stream.cuda_stream), "while_set")


def while_end(body: torch.cuda.Stream) -> None:
    """End the capture of the WHILE node's body begun by `while_begin`."""
    _check(load_library().benlsip_while_end(body.cuda_stream), "while_end")


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [_PTR, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [_PTR, ctypes.POINTER(ctypes.c_int)]
    return drv


# CUgraphNodeType of kernel nodes, and of memcpy and memset nodes.
_KERNEL_NODE, _COPY_NODES = 0, (1, 2)


def graph_nodes(graph: int) -> tuple:
    """(kernel nodes, copy and memset nodes) of the cudaGraph_t `graph`
    (the driver's CUgraph), the bodies of its WHILE nodes apart: a body's
    counts times the trips its loop ran are the device operations a replay
    ran there, which a profiler's trace does not show."""
    drv, n = _driver(), ctypes.c_size_t()

    def check(rc: int, call: str) -> None:
        if rc != 0:
            raise RuntimeError(f"graph_nodes: {call} failed (CUresult {rc})")

    check(drv.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts, kind = [0, 0], ctypes.c_int()
    for node in nodes:
        check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        counts[0] += kind.value == _KERNEL_NODE
        counts[1] += kind.value in _COPY_NODES
    return tuple(counts)


@functools.lru_cache(maxsize=None)
def _kernel_fn(base: str, dtype: torch.dtype):
    if load_library.cache_info().currsize == 0 and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{base}: the kernel library would be built and loaded inside a CUDA graph "
                           "capture; call load_library() before capturing")
    return getattr(load_library(), f"{base}_{'f32' if dtype == torch.float32 else 'f64'}")


def _launch(name: str, base: str, t: Tensor, *args) -> None:
    fn = _kernel_fn(base, t.dtype)
    if t.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(t.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _check(rc, f"{name}: kernel launch")
    counts = CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES
    with _COUNT_LOCK:     # the overlapped pipeline launches from two threads
        counts[name] += 1


def _require_cuda(name: str, *ts: Tensor, strided: tuple = ()) -> None:
    """Raise unless every tensor is float32/float64 on one CUDA device and
    contiguous; the tensors in `strided` are exempt from the last check."""
    ts = strided + ts
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}; the kernel runs on CUDA tensors only")
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(f"{name}: bf16 is not ported yet")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: dtype {t.dtype} (the kernel takes float32 or float64)")
    if not all(t.is_contiguous() for t in ts[len(strided):]):
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


# ---------------------------------------------------------------------------
# R factor of wide matrices (left-looking block modified Gram–Schmidt)
# ---------------------------------------------------------------------------


def qr_panel_layout(D: int, itemsize: int):
    """(panel width, leading dimension) of the panel QR kernel for D rows:
    the rows padded to a multiple of 4 and then to 4 mod 32 (shared-memory
    banks), and the widest panel that fits, beside one width × width block
    per warp and two rows of scalars, in the shared memory of one block.
    None when not even the narrowest fits."""
    ld = -(-D // 4) * 4
    ld += (4 - ld) % 32
    for bw in QR_PANEL_WIDTHS:
        if (bw * ld + QR_BLOCK_WARPS * bw * bw + 2 * bw) * itemsize <= MAX_DYNAMIC_SMEM:
            return bw, ld
    return None


def blocked_qr_r_plain(S: Tensor) -> Tensor:
    """Plain PyTorch twin of the panel QR kernel, in the same panel order:
    each panel has the finished panels projected out one after another
    (W = QⱼᵀP into R, P −= QⱼW), then modified Gram–Schmidt inside the panel
    on unnormalised columns (dots s with column c, R row s/√max(s_cc, tiny),
    later columns −= column c · s/max(s_cc, tiny)), then the division by
    the norms."""
    B, D, N = S.shape
    layout = qr_panel_layout(D, S.element_size())
    bw = layout[0] if layout else QR_PANEL_WIDTHS[-1]
    tiny = torch.finfo(S.dtype).tiny
    R = torch.zeros((B, N, N), dtype=S.dtype, device=S.device)
    finished = []
    for c0 in range(0, N, bw):
        P = S[:, :, c0:c0 + bw].clone()
        nc = P.shape[-1]
        for j0, Qj in finished:
            W = Qj.mT @ P
            R[:, j0:j0 + bw, c0:c0 + nc] = W
            P -= Qj @ W
        nrm = torch.empty((B, nc), dtype=S.dtype, device=S.device)
        for c in range(nc):
            s = (P[:, :, c:c + 1] * P[:, :, c:]).sum(1)          # (B, nc - c)
            ss = torch.clamp_min(s[:, 0], tiny)
            nrm[:, c] = torch.sqrt(ss)
            R[:, c0 + c, c0 + c:c0 + nc] = s / nrm[:, c:c + 1]
            R[:, c0 + c, c0 + c] = nrm[:, c]
            P[:, :, c + 1:] -= P[:, :, c:c + 1] * (s[:, 1:] / ss[:, None]).unsqueeze(1)
        if c0 + bw < N:
            finished.append((c0, P / nrm.unsqueeze(1)))
    return R


def blocked_qr_r(S: Tensor) -> Tensor:
    """R factor of a batch of tall matrices: S (B, D, N), D ≥ N -> upper
    triangular R (B, N, N) with RᵀR = SᵀS and a positive diagonal.  S is
    not written."""
    if S.ndim != 3 or S.shape[1] < S.shape[2]:
        raise ValueError(f"blocked_qr_r: expected (B, D, N) with D >= N, got {tuple(S.shape)}")
    B, D, N = S.shape
    if B == 0 or N == 0:
        return torch.zeros((B, N, N), dtype=S.dtype, device=S.device)
    if _on_cpu(S):
        return blocked_qr_r_plain(S)
    _require_cuda("blocked_qr_r", S)
    layout = qr_panel_layout(D, S.element_size())
    if layout is None:
        raise ValueError(f"blocked_qr_r: a panel of D={D} rows does not fit in shared memory")
    bw, ld = layout
    R = torch.empty((B, N, N), dtype=S.dtype, device=S.device)
    # The finished Q panels, all but the last, column-major with leading dimension ld.
    ws = torch.empty((B, (-(-N // bw) - 1) * bw * ld), dtype=S.dtype, device=S.device)
    _launch("blocked_qr_r", "benlsip_blocked_qr_r", S, S.data_ptr(), R.data_ptr(), ws.data_ptr(), B, D, N, bw, ld)
    return R


# ---------------------------------------------------------------------------
# Fused call sites: masked Gram + Cholesky, masked tangent projection
# ---------------------------------------------------------------------------


def has_row_major_blocks(A: Tensor) -> bool:
    """True when every (m, n) block of A (B, m, n) is row-major contiguous,
    whatever the batch stride: a stride-0 expand of one matrix qualifies."""
    _, m, n = A.shape
    return (n == 1 or A.stride(2) == 1) and (m == 1 or A.stride(1) == n)


def _fused_args(name: str, A: Tensor, mask: Tensor, *rest: Tensor) -> int:
    """Check the operands of a fused kernel; returns A's batch stride in
    elements (0 for a batch that shares one matrix)."""
    B, M, n = A.shape
    _require_cuda(name, *rest, strided=(A,))
    if mask.dtype != torch.bool or mask.device != A.device or not mask.is_contiguous():
        raise ValueError(f"{name}: the mask must be a contiguous bool tensor on {A.device}")
    if not has_row_major_blocks(A):
        raise ValueError(f"{name}: A needs row-major (m, n) blocks, got strides {A.stride()}")
    if not (0 < M <= MAX_DIM and n > 0):
        raise ValueError(f"{name}: need 0 < m <= {MAX_DIM} and n > 0, got m={M}, n={n}")
    return A.stride(0) if B > 1 else 0


def masked_aat(A: Tensor, free: Tensor) -> Tensor:
    """A Z Aᵀ with Z = diag(free): (B, m, n), (B, n) -> (B, m, m)."""
    Af = A * free.to(A.dtype).unsqueeze(-2)
    return Af @ A.mT


def masked_aat_cholesky_plain(A: Tensor, fixed: Tensor, reg: float = 0.0) -> Tensor:
    """Plain PyTorch twin of the fused factor kernel: the masked product,
    the jitter, then the plain Cholesky."""
    K = masked_aat(A, ~fixed)
    if reg:
        K = K + reg * torch.eye(A.shape[-2], dtype=A.dtype, device=A.device)
    return batched_cholesky_plain(K)


def masked_aat_cholesky(A: Tensor, fixed: Tensor, reg: float = 0.0) -> Tensor:
    """Lower factor of A Z Aᵀ + reg·I, Z = diag(¬fixed), for a batch:
    A (B, m, n), bool fixed (B, n) -> L (B, m, m).  A may share one matrix
    across the batch (stride 0)."""
    if A.ndim != 3 or fixed.shape != A.shape[::2]:
        raise ValueError(f"masked_aat_cholesky: expected (B, m, n) and (B, n), got {tuple(A.shape)}, {tuple(fixed.shape)}")
    B, M, _ = A.shape
    if B == 0 or M == 0:
        return torch.zeros((B, M, M), dtype=A.dtype, device=A.device)
    if _on_cpu(A):
        return masked_aat_cholesky_plain(A, fixed, reg)
    stride = _fused_args("masked_aat_cholesky", A, fixed)
    L = torch.empty((B, M, M), dtype=A.dtype, device=A.device)
    _launch(
        "masked_aat_cholesky", "benlsip_masked_aat_cholesky", A,
        A.data_ptr(), stride, fixed.data_ptr(), float(reg), L.data_ptr(), B, M, A.shape[2],
    )
    return L


def project_tangent_plain(A: Tensor, L: Tensor, fixed: Tensor, r: Tensor, unmasked_output: bool = False) -> Tensor:
    """Plain PyTorch twin of the fused projection kernel: mask, A Z r, the
    plain Cholesky solve, Aᵀw, mask, subtract."""
    free = ~fixed
    rz = torch.where(free, r, 0.0)
    w = batched_cho_solve_plain(L, (A @ rz.unsqueeze(-1)).squeeze(-1))
    atw = (A.mT @ w.unsqueeze(-1)).squeeze(-1)
    if unmasked_output:
        return r - atw
    return rz - torch.where(free, atw, 0.0)


def project_tangent(A: Tensor, L: Tensor, fixed: Tensor, r: Tensor, unmasked_output: bool = False) -> Tensor:
    """Z r − Z Aᵀ w with w = (L Lᵀ)⁻¹ A Z r and Z = diag(¬fixed), for a
    batch: A (B, m, n), L (B, m, m), bool fixed (B, n), r (B, n) -> (B, n).
    With `unmasked_output` it returns r − Aᵀ w for the same w.  A may share
    one matrix across the batch (stride 0)."""
    if A.ndim != 3 or L.shape != A.shape[:2] + A.shape[1:2] or r.shape != A.shape[::2] or fixed.shape != r.shape:
        raise ValueError(
            "project_tangent: expected (B, m, n), (B, m, m), (B, n), (B, n), got "
            f"{tuple(A.shape)}, {tuple(L.shape)}, {tuple(fixed.shape)}, {tuple(r.shape)}"
        )
    B, M, n = A.shape
    if M == 0:
        raise ValueError("project_tangent: m = 0 has no factor to solve with")
    if B == 0 or n == 0:
        return torch.zeros_like(r)
    if _on_cpu(A):
        return project_tangent_plain(A, L, fixed, r, unmasked_output)
    stride = _fused_args("project_tangent", A, fixed, L, r)
    out = torch.empty_like(r)
    _launch(
        "project_tangent", "benlsip_project_tangent", A,
        A.data_ptr(), stride, L.data_ptr(), fixed.data_ptr(), r.data_ptr(), out.data_ptr(),
        B, M, n, int(unmasked_output),
    )
    return out
