"""Hand-written Hopper kernels for batched small-matrix linear algebra.

CUDA C++ twins of the three Pallas TPU kernels of
`benlsip_tpu/kernels/batched_linalg.py`:

* `batched_cholesky`  ← `batched_cholesky` / `_cholesky_kernel`  (:44, :74)
* `batched_cho_solve` ← `batched_cho_solve` / `_cho_solve_kernel` (:101, :119)
* `batched_thin_qr`   ← `batched_thin_qr` / `_mgs_qr_kernel`     (:147, :170)

and the kernels that redesign them for this card:

* the narrow thin QR itself (`csrc/thin_qr.cuh`): an instance read once and
  factored in registers, G lanes an instance (the group form) or in shared
  memory, one block an instance (the wide form), by `narrow_qr_plan(D, N,
  dtype)`; `batched_thin_qr` returns Q and R, `narrow_qr_r` R only, of S or
  of the stacked [S; diag(dbot)] (the polish's factor, one launch);

* `masked_aat_cholesky`: L = chol(A Z Aᵀ + reg·I), the Cholesky kernel
  with the masked Gram product in front of it, one launch per call site;
* `project_tangent`: Z r − Z Aᵀ (L Lᵀ)⁻¹ A Z r, the solve kernel with
  the mask and both products with A around it, one launch per call site;

  each of these two in one of two forms, by `fused_plan(m, n, dtype)`: one
  warp per instance (plan 1, every n up to `SPLIT_MIN_N`), or, for large
  n, a thread-block cluster of S blocks per instance that splits the n
  columns and adds the blocks' partial sums in rank order (plan S);
* `blocked_qr_r`: the R factor of wide tall matrices (16 < N), of S or of
  the stacked [S; diag(dbot)], a panel QR where the TPU kernel's gate left
  the factorization to the library: a thread-block cluster per instance
  that splits the rows (`blocked_qr_plan(D, N, dtype)`), the panel
  products on the tensor cores in 3xTF32;
* `polyhedron_newton`: the whole dual Newton of the polyhedral projection
  (`ops/polyproject`), the factor and the solve of each trip inside it, each
  instance to its own exit in one launch; in one of three layouts by
  `newton_plan(m, n, dtype)`: one warp per instance with the line search's
  grid points on the lanes (plan 0, n up to `NEWTON_LANES_MAX_N`) or with
  the columns on the lanes (plan 1), or the fused kernels' cluster of S
  blocks per instance (plan S, from `SPLIT_MIN_N` on);
* `minor_direction_r`: the whole minor iteration of `solver/inner` on the
  materialized operator R (RᵀR = H) — the free-variable box, the projected
  CG to each instance's own exit, the line search — one block an instance
  with R in shared memory, one launch a minor iteration (it replaces no TPU
  kernel: the JAX package's CG is `lax.while_loop` code that XLA fuses);
* `minor_loop_r`: the whole minor loop of `solver/inner.inner_step` on the
  same operator — each trip that minor iteration (the same device code),
  s and the model gradient updated, the bound masks, the re-factor of the
  new free set and the two reduced-gradient norms — each instance to its
  own exit, one launch an inner step (it replaces no TPU kernel either).

The small kernels (all but the panel QR and the dual Newton) take float32, float64 and bfloat16, as the TPU
kernels take float32 and bfloat16: a bf16 kernel computes in float32 and
rounds each output once, and its plain version is the float32 plain
version on the upcast inputs, rounded once (`_rounded_from_f32`).  The
panel QR kernel takes float32 and float64 only (the JAX package has no wide
QR kernel; `ops/qr.qr_r` factors a wide bf16 matrix in float32), the dual
Newton float32 and bfloat16 only (float64 projections run the plain loop).

Each wrapper keeps the JAX package's public layout — (B, M, M), (B, M) and
(B, D, N), row-major — and none of the TPU's batch-last transposes or lane
padding.  On a CUDA tensor it launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, which computes the
same algorithm in the same order with batched torch ops (the dual Newton's
plain version is the masked loop of `ops/polyproject`, registered here by
`set_newton_plain`, the minor iteration's is `solver/inner`'s
composition of `projected_cg` and `linesearch`, registered by
`set_minor_plain`, and the minor loop's is `solver/inner`'s masked loop,
registered by `set_minor_loop_plain`).  There is no
fallback from a failed build or launch to the plain version.

The sources in `csrc/` are compiled with nvcc for sm_90a (one nvcc per
source, all started together) and linked into one shared
library with a plain C interface on first use, into `_build/` keyed on a
hash of the sources and flags, and loaded with ctypes.  Each wrapper adds
one to its entry of `LAUNCHES` when it launches its kernel, and nowhere
else, so a run can show that the main path went through the kernels;
`LAUNCHES_BY_DTYPE` counts the same launches by (kernel, dtype name), so it
can also show which instantiation ran, and `LAUNCHES_BY_PLAN` those of the
two fused kernels by (kernel, plan), so it can show which form ran.

A wrapper called inside a CUDA graph capture records its kernel into the
graph instead (`_launch` is stream-ordered, allocates nothing itself, and
the kernels call only `cudaGetLastError` and `cudaFuncSetAttribute`): it
adds one to `CAPTURED`, not to `LAUNCHES`.  What the replays run is
counted by the graphs' owner (`batch/fused_small.replay_counts`: captured
launches of each WHILE body times the trips its loop ran).  The library
must be built and loaded before a capture; a first load inside one raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import torch

Tensor = torch.Tensor

MAX_DIM = 16        # largest M (Cholesky, solve) and N (QR) the kernels take
MAX_QR_ROWS = 2048  # largest D the QR kernels take (the JAX gate's bound)
# The narrow QR's group form (csrc/thin_qr.cuh): a lane holds at most
# NARROW_QR_LANE_ROWS rows of its instance and at most
# NARROW_QR_LANE_REGISTERS 32-bit registers of them (the rows a power of two); the wide form's block
# has NARROW_QR_WIDE_WARPS warps (their partial sums in static shared memory).
NARROW_QR_LANE_ROWS = 8
NARROW_QR_LANE_REGISTERS = 128
NARROW_QR_WIDE_WARPS = 8
# The panel QR kernel behind `ops/qr.qr_r`: as many columns as it is measured
# against the library call, and as few instances as it still beats it with
# (the library gives each matrix the whole card in turn).
MAX_BLOCKED_QR_COLS = 256
MIN_BLOCKED_QR_BATCH = 4
# Its plan (csrc/blocked_qr.cu): panels of 64 columns in float32 (the
# tensor-core form), 32 in float64; a cluster of 1, 2, 4 or 8 blocks an
# instance, each over a slice of at most QR_BLOCK_ROWS rows, padded to a
# multiple of QR_ROW_TILE (the tensor cores' 16-row tiles).
QR_PANEL_WIDTH = {torch.float32: 64, torch.float64: 32}
QR_CLUSTER_SIZES = (1, 2, 4, 8)
QR_BLOCK_ROWS = 640
QR_ROW_TILE = 16
MAX_DYNAMIC_SMEM = 232448        # bytes of shared memory a block may opt in to on sm_90
# The split form of the fused kernels (csrc/common.cuh): blocks of
# SPLIT_THREADS threads, at most MAX_CLUSTER of them per instance (above 8 a
# non-portable cluster size).  From SPLIT_MIN_N columns on, the plan is the
# fewest blocks, a power of two from 2, that give each thread at most one
# column, or MAX_CLUSTER; below it, one warp per instance (measured: PERF.md).
SPLIT_THREADS = 256
MAX_CLUSTER = 16
SPLIT_MIN_N = 512
# The dual Newton's warp form puts the line search's grid points on the lanes
# up to this many columns (one column a lane), the columns above it.
NEWTON_LANES_MAX_N = 32
# The minor-iteration kernels (csrc/minor_direction_r.cu, csrc/minor_loop_r.cu,
# one device code in csrc/minor_iteration.cuh): one block of MINOR_THREADS
# threads an instance, one column a thread (n ≤ MINOR_THREADS), R and the
# shared vectors in dynamic shared memory (`minor_direction_smem`, one layout
# for both); MINOR_RED_FLOATS floats of it hold the block reductions.
MINOR_THREADS = 256
MINOR_RED_FLOATS = 96
# Components of the CG direction below this size do not bind the box
# (`solver/cg.factor_to_boundary`'s atol); the negative-curvature test's
# tolerance is sqrt(eps) of float32, as `solver/cg.projected_cg`'s.
MINOR_BOUND_ATOL = 1e-10

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
    "batched_cholesky": 0, "batched_cho_solve": 0, "batched_thin_qr": 0, "narrow_qr_r": 0,
    "masked_aat_cholesky": 0, "project_tangent": 0, "blocked_qr_r": 0, "polyhedron_newton": 0,
    "minor_direction_r": 0, "minor_loop_r": 0,
}
CAPTURED = dict.fromkeys(LAUNCHES, 0)   # launches recorded into CUDA graphs
# The same launches as LAUNCHES by (kernel, dtype name), e.g.
# ("project_tangent", "bfloat16"), and the fused kernels' and the dual
# Newton's by (kernel, plan), e.g. ("masked_aat_cholesky", 8): plan 1 is the
# warp form (for the dual Newton with the columns on the lanes, plan 0 with
# the grid points on the lanes).
LAUNCHES_BY_DTYPE: Counter = Counter()
LAUNCHES_BY_PLAN: Counter = Counter()
_COUNT_LOCK = threading.Lock()

# The C entry points' suffix for each dtype; the panel QR kernel has no bf16.
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_SMALL_DTYPES = tuple(_SUFFIX)
_WIDE_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    """Set every kernel's launch and capture count to 0."""
    for counts in (LAUNCHES, CAPTURED):
        for k in counts:
            counts[k] = 0
    LAUNCHES_BY_DTYPE.clear()
    LAUNCHES_BY_PLAN.clear()


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
    # A, dbot (or null), Q (or null), R, B, D, N, plan, stream
    "benlsip_thin_qr": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # A, its batch stride, fixed, reg, L, B, M, n, plan (blocks per instance), stream
    "benlsip_masked_aat_cholesky": [_PTR, ctypes.c_longlong, _PTR, ctypes.c_double, _PTR] + [_INT] * 4 + [_PTR],
    # A, its batch stride, L, fixed, r, out, B, M, n, unmasked_output, plan, stream
    "benlsip_project_tangent": [_PTR, ctypes.c_longlong] + [_PTR] * 4 + [_INT] * 5 + [_PTR],
    # S, dbot (or null), R, workspace, B, D, N, cluster size, rows a block, leading dimension, stream
    "benlsip_blocked_qr_r": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    # A, its batch stride, b, l, u, x, lam0, active, tol, reg, max_iter, grow_pows,
    # n_section, v, lam, iters, workspace, B, M, n, plan, stream
    "benlsip_polyhedron_newton": [_PTR, ctypes.c_longlong] + [_PTR] * 6 + [ctypes.c_double] * 2 + [_INT] * 3
    + [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # R, A, its batch stride, L, fixed, x, s, g, xl, its batch stride, xu, its batch
    # stride, delta, active, kappa2, atol, bound_atol, w, status, iters, B, k, M, n,
    # shared-memory bytes, stream
    "benlsip_minor_direction_r": [_PTR, _PTR, ctypes.c_longlong] + [_PTR] * 6 + [ctypes.c_longlong, _PTR,
                                  ctypes.c_longlong] + [_PTR] * 2 + [ctypes.c_double] * 3 + [_PTR] * 3 + [_INT] * 4
    + [ctypes.c_longlong, _PTR],
    # R, A, its batch stride, L, fixed, x, s, g, g_minor, xl, its batch stride, xu, its
    # batch stride, delta, run, max_minor, kappa2, kappa3, atol, bound_atol, fix_atol,
    # reg, s, g_minor, fixed, L (the outputs), trips, CG trips, status, B, k, M, n,
    # shared-memory bytes, stream
    "benlsip_minor_loop_r": [_PTR, _PTR, ctypes.c_longlong] + [_PTR] * 6 + [_PTR, ctypes.c_longlong, _PTR,
                             ctypes.c_longlong] + [_PTR] * 3 + [ctypes.c_double] * 6 + [_PTR] * 7 + [_INT] * 4
    + [ctypes.c_longlong, _PTR],
}
# The dtypes of each C entry point that has not all three.
_ENTRY_SUFFIXES = {"benlsip_blocked_qr_r": ("f32", "f64"), "benlsip_polyhedron_newton": ("f32", "bf16"),
                   "benlsip_minor_direction_r": ("f32",), "benlsip_minor_loop_r": ("f32",)}


def build() -> Path:
    """Compile `csrc/*.cu` with nvcc if the library for these sources is missing:
    one nvcc per source, all started together, then one link.

    The ptxas report (registers, spills per kernel) and each source's
    compile seconds are kept beside the library as `<name>.log`.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs, t0 = [], time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            fmad = f"--fmad={'true' if src.name in FMAD_SOURCES else 'false'}"
            cmd = [nvcc, *NVCC_FLAGS, fmad, "-c", str(src), "-o", str(Path(tmp) / f"{src.stem}.o")]
            output = open(Path(tmp) / f"{src.stem}.out", "w+")   # a file: a full pipe would stall nvcc
            jobs.append((src.name, cmd, output, subprocess.Popen(cmd, stdout=output, stderr=subprocess.STDOUT, text=True)))
        link = [nvcc, *NVCC_ARCH, "-shared", "-o", str(Path(tmp) / out.name), *[job[1][-1] for job in jobs]]
        seconds = {}
        while len(seconds) < len(jobs):   # wait for every compile, so none outlives a failure
            for name, _, _, proc in jobs:
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        report, failed = [], []
        for name, cmd, output, proc in jobs:
            output.seek(0)
            text = output.read()
            output.close()
            report.append(f"== {name}: compiled in {seconds[name]:.1f} s\n{text}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stderr}")
        out.with_suffix(".log").write_text("".join(report))
        os.replace(Path(tmp) / out.name, out)
    return out


# The context the first load runs in: the set-up span `library_load` of
# `_trace`, a module above this one, which registers it when it is
# imported, so nothing here imports from above `kernels/`.
_LOAD_SPAN = contextlib.nullcontext


def set_load_span(fn) -> None:
    """Register the context manager factory the first `load_library()`
    runs in (`_trace`'s set-up span)."""
    global _LOAD_SPAN
    _LOAD_SPAN = fn


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, the build and
    the load inside the registered `set_load_span` context."""
    with _LOAD_SPAN():
        lib = ctypes.CDLL(str(build()))
    for base, argtypes in _SIGNATURES.items():
        for suffix in _ENTRY_SUFFIXES.get(base, ("f32", "f64", "bf16")):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.benlsip_error_string.argtypes = [ctypes.c_int]
    lib.benlsip_error_string.restype = ctypes.c_char_p
    # The conditional WHILE and IF nodes of graph capture (`csrc/graph_conditional.cu`).
    for fn in (lib.benlsip_while_begin, lib.benlsip_if_begin):
        fn.argtypes = [_PTR, _PTR, _PTR, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_void_p)]
    lib.benlsip_while_set.argtypes = [ctypes.c_ulonglong, _PTR, _PTR]
    lib.benlsip_body_end.argtypes = [_PTR]
    for fn in (lib.benlsip_while_begin, lib.benlsip_if_begin, lib.benlsip_while_set, lib.benlsip_body_end):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {load_library().benlsip_error_string(rc).decode()} (cudaError {rc})")


def conditional_begin(kind: str, pred: Tensor, parent: torch.cuda.Stream, body: torch.cuda.Stream) -> tuple:
    """In the graph being captured on `parent`, add a conditional node of
    `kind` ("while": runs its body while its handle is set; "if": once if
    it is set), set the handle from the bool `pred` (a 0-dim CUDA tensor),
    and start capturing `body` into the node's body; returns the handle and
    the body graph (a cudaGraph_t)."""
    lib = load_library()
    begin = {"while": lib.benlsip_while_begin, "if": lib.benlsip_if_begin}[kind]
    handle, graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    _check(begin(pred.data_ptr(), parent.cuda_stream, body.cuda_stream, ctypes.byref(handle), ctypes.byref(graph)),
           f"{kind}_begin")
    return handle.value, graph.value


def while_set(handle: int, pred: Tensor, stream: torch.cuda.Stream) -> None:
    """Capture on `stream` the kernel that sets `handle` from `pred`."""
    _check(load_library().benlsip_while_set(handle, pred.data_ptr(), stream.cuda_stream), "while_set")


def body_end(body: torch.cuda.Stream) -> None:
    """End the capture of a conditional node's body begun by `conditional_begin`."""
    _check(load_library().benlsip_body_end(body.cuda_stream), "body_end")


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
    return getattr(load_library(), f"{base}_{_SUFFIX[dtype]}")


def _launch(name: str, base: str, t: Tensor, *args, plan: int | None = None) -> None:
    """Launch `base`'s kernel for t's dtype on the current stream and count
    it; `plan`, for the fused kernels, is also its last argument."""
    if plan is not None:
        args = (*args, plan)
    fn = _kernel_fn(base, t.dtype)
    if t.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(t.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _check(rc, f"{name}: kernel launch")
    captured = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:     # the overlapped pipeline launches from two threads
        if captured:
            CAPTURED[name] += 1
        else:
            LAUNCHES[name] += 1
            LAUNCHES_BY_DTYPE[name, str(t.dtype).removeprefix("torch.")] += 1
            if plan is not None:
                LAUNCHES_BY_PLAN[name, plan] += 1


def _require_cuda(name: str, *ts: Tensor, strided: tuple = (), dtypes: tuple = _SMALL_DTYPES) -> None:
    """Raise unless every tensor is of one of `dtypes` on one CUDA device
    and contiguous; the tensors in `strided` are exempt from the last check."""
    ts = strided + ts
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}; the kernel runs on CUDA tensors only")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} (the kernel takes {', '.join(str(d) for d in dtypes)})")
    if not all(t.is_contiguous() for t in ts[len(strided):]):
        raise ValueError(f"{name}: the kernel needs contiguous row-major tensors")
    if any(t.dtype != ts[0].dtype or t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: all tensors must share dtype and device")


def _rounded_from_f32(plain, *args):
    """The bf16 plain version of a kernel: `plain` on the float32 upcast of
    every bf16 tensor argument, each output rounded once to bf16 (the bf16
    kernel computes in float32 and rounds on its stores)."""
    up = [a.float() if isinstance(a, Tensor) and a.dtype == torch.bfloat16 else a for a in args]
    out = plain(*up)
    if isinstance(out, tuple):
        return tuple(o.to(torch.bfloat16) for o in out)
    return out.to(torch.bfloat16)


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
    if K.dtype == torch.bfloat16:
        return _rounded_from_f32(batched_cholesky_plain, K)
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
    if L.dtype == torch.bfloat16:
        return _rounded_from_f32(batched_cho_solve_plain, L, b)
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
    if A.dtype == torch.bfloat16:
        return _rounded_from_f32(batched_thin_qr_plain, A)
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


def narrow_qr_plan(D: int, N: int, dtype: torch.dtype) -> int:
    """Layout of the narrow QR kernel for an instance of D rows (the stacked
    rows included) and N columns: G ≥ 1, the group form with G lanes an
    instance (the fewest, a power of two up to 32, that leave each lane at
    most its share of rows), or 0, the wide form (one block an instance,
    the instance in shared memory).  A function of the shape only, never of
    the batch, so that a lane's bits do not depend on the batch it runs in."""
    words = 2 if dtype == torch.float64 else 1
    rows = NARROW_QR_LANE_ROWS              # a power of two: the kernel's slot counts are 1, 2, 4, 8
    while rows > 1 and rows * N * words > NARROW_QR_LANE_REGISTERS:
        rows //= 2
    G = 1
    while G <= 32:
        if -(-D // G) <= rows:
            return G
        G *= 2
    return 0


def _narrow_qr_args(name: str, S: Tensor, dbot) -> int:
    """Check the operands of the narrow QR kernel on the card; returns the
    plan.  D counts the stacked rows of dbot."""
    _require_cuda(name, S, *(() if dbot is None else (dbot,)))
    B, D, N = S.shape
    if dbot is not None:
        D += N
    if not (N <= MAX_DIM and N <= D <= MAX_QR_ROWS):
        raise ValueError(f"{name}: need N <= {MAX_DIM} and N <= D <= {MAX_QR_ROWS} (stacked rows included), got D={D}, N={N}")
    plan = narrow_qr_plan(D, N, S.dtype)
    compute_size = 8 if S.dtype == torch.float64 else 4
    if plan == 0 and (D | 1) * N * compute_size + NARROW_QR_WIDE_WARPS * MAX_DIM * compute_size > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: a {D}x{N} {S.dtype} instance does not fit in one block's shared memory")
    return plan


def batched_thin_qr(A: Tensor):
    """Thin QR of a batch: A (B, D, N) -> (Q (B, D, N), R (B, N, N))."""
    if A.ndim != 3:
        raise ValueError(f"batched_thin_qr: expected (B, D, N), got {tuple(A.shape)}")
    B, D, N = A.shape
    if B == 0 or N == 0:
        return torch.zeros_like(A), torch.zeros((B, N, N), dtype=A.dtype, device=A.device)
    if _on_cpu(A):
        return batched_thin_qr_plain(A)
    plan = _narrow_qr_args("batched_thin_qr", A, None)
    Q = torch.empty_like(A)
    R = torch.empty((B, N, N), dtype=A.dtype, device=A.device)
    _launch("batched_thin_qr", "benlsip_thin_qr", A, A.data_ptr(), None, Q.data_ptr(), R.data_ptr(), B, D, N, plan)
    return Q, R


def narrow_qr_r_plain(S: Tensor, dbot=None) -> Tensor:
    """Plain PyTorch twin of the R-only narrow QR: `batched_thin_qr_plain`
    of S, or of the stacked [S; diag(dbot)], R only."""
    if dbot is not None:
        S = torch.cat([S, torch.diag_embed(dbot)], dim=-2)
    return batched_thin_qr_plain(S)[1]


def narrow_qr_r(S: Tensor, dbot=None) -> Tensor:
    """R factor of a batch by the narrow QR kernel, no Q written: S (B, D, N)
    -> R (B, N, N); with dbot (B, N), R of [S; diag(dbot)] (B, D + N, N)
    without the stacked matrix.  On the card R is bitwise the R of
    `batched_thin_qr` of the same (stacked) matrix."""
    if S.ndim != 3 or (dbot is not None and tuple(dbot.shape) != (S.shape[0], S.shape[2])):
        raise ValueError(f"narrow_qr_r: expected (B, D, N) and (B, N), got {tuple(S.shape)}, "
                         f"{None if dbot is None else tuple(dbot.shape)}")
    B, D, N = S.shape
    if B == 0 or N == 0:
        return torch.zeros((B, N, N), dtype=S.dtype, device=S.device)
    if _on_cpu(S):
        return narrow_qr_r_plain(S, dbot)
    plan = _narrow_qr_args("narrow_qr_r", S, dbot)
    R = torch.empty((B, N, N), dtype=S.dtype, device=S.device)
    _launch("narrow_qr_r", "benlsip_thin_qr", S, S.data_ptr(), None if dbot is None else dbot.data_ptr(), None,
            R.data_ptr(), B, D, N, plan)
    return R


# ---------------------------------------------------------------------------
# R factor of wide matrices (left-looking block Gram–Schmidt, two passes,
# each finished panel reorthogonalized by one CholeskyQR step)
# ---------------------------------------------------------------------------


def blocked_qr_plan(D: int, N: int, dtype: torch.dtype):
    """(C, panel width, rows, LD) of the panel QR kernel for an instance of D
    rows (stacked rows included) and N columns of `dtype`: the fewest blocks
    a cluster, C in QR_CLUSTER_SIZES, whose row slices hold at most
    QR_BLOCK_ROWS rows; each slice padded to a multiple of QR_ROW_TILE rows;
    the panel's leading dimension LD the padded rows brought to 4 mod 32
    (shared-memory banks).  A function of the shape and dtype only, never of
    the batch, so that an instance's bits do not depend on its batch.  None
    when the kernel cannot take the instance (more than 8 blocks' rows, a
    dtype without a kernel, or a block's shared memory above 227 KB)."""
    bw = QR_PANEL_WIDTH.get(dtype)
    if bw is None or D < 1 or N < 1:
        return None
    C = next((c for c in QR_CLUSTER_SIZES if -(-D // c) <= QR_BLOCK_ROWS), None)
    if C is None:
        return None
    rows = -(-(-(-D // C)) // QR_ROW_TILE) * QR_ROW_TILE
    ld = rows + (4 - rows) % 32
    if blocked_qr_smem(ld, dtype) > MAX_DYNAMIC_SMEM:
        return None
    return C, bw, rows, ld


def blocked_qr_smem(ld: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a block of the panel QR kernel takes: the
    panel (width × ld), three width × (width + 4) blocks (two partial sums
    and the reduced one), the column steps' partial dots (two rows of width
    scalars for each block of the largest cluster) and the column norms."""
    bw = QR_PANEL_WIDTH[dtype]
    return (bw * ld + 3 * bw * (bw + 4) + (2 * QR_CLUSTER_SIZES[-1] + 1) * bw) * torch.finfo(dtype).bits // 8


def blocked_qr_r_plain(S: Tensor, dbot=None) -> Tensor:
    """Plain PyTorch twin of the panel QR kernel, in the same panel order
    and at its panel width: each panel has the finished panels projected out
    one after another, twice (W = QⱼᵀP added into R, P −= QⱼW; the second
    pass takes out what the first left: block CGS2), then modified
    Gram–Schmidt inside the panel on unnormalised columns (dots s with
    column c, R row s/√max(s_cc, tiny), later columns −= column c ·
    s/max(s_cc, tiny)), then the division by the norms.  A panel whose Q the
    later panels reuse is then reorthogonalized by one CholeskyQR step,
    since modified Gram–Schmidt leaves it κ(panel)·eps off orthonormal and
    "twice is enough" assumes it orthonormal: G = QᵀQ, R₂ = chol(G),
    Q ← QR₂⁻¹ and the panel's diagonal block of R ← R₂R₁.  A panel whose G
    is not positive definite (a zero or NaN column) keeps R₂ = I.  With dbot
    (B, N), R of the stacked [S; diag(dbot)]."""
    if dbot is not None:
        S = torch.cat([S, torch.diag_embed(dbot)], dim=-2)
    B, D, N = S.shape
    bw = QR_PANEL_WIDTH.get(S.dtype, QR_PANEL_WIDTH[torch.float32])
    tiny = torch.finfo(S.dtype).tiny
    R = torch.zeros((B, N, N), dtype=S.dtype, device=S.device)
    finished = []
    for c0 in range(0, N, bw):
        P = S[:, :, c0:c0 + bw].clone()
        nc = P.shape[-1]
        for _ in range(2):
            for j0, Qj in finished:
                W = Qj.mT @ P
                R[:, j0:j0 + bw, c0:c0 + nc] += W
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
            Q = P / nrm.unsqueeze(1)
            L, info = torch.linalg.cholesky_ex(Q.mT @ Q)
            ok = ((info == 0) & torch.isfinite(L).flatten(1).all(-1))[:, None, None]
            eye = torch.eye(nc, dtype=S.dtype, device=S.device)
            R2 = torch.where(ok, L.mT, eye)
            R1 = R[:, c0:c0 + nc, c0:c0 + nc]
            R[:, c0:c0 + nc, c0:c0 + nc] = torch.where(ok, R2 @ R1, R1)
            R2inv = torch.linalg.solve_triangular(R2, eye.expand(B, nc, nc), upper=True)
            finished.append((c0, torch.where(ok, Q @ R2inv, Q)))
    return R


def blocked_qr_r(S: Tensor, dbot=None) -> Tensor:
    """R factor of a batch of tall matrices: S (B, D, N), D ≥ N -> upper
    triangular R (B, N, N) with RᵀR = SᵀS and a positive diagonal; with
    dbot (B, N), R of the stacked [S; diag(dbot)] (B, D + N, N) without the
    stacked matrix, bitwise the R of the stacked matrix (the kernel makes
    the diagonal rows up as it loads them; on a CPU tensor the plain version
    runs on the stacked matrix).  S is not written.  float32 and float64
    only, on either device."""
    if S.ndim != 3 or (dbot is not None and tuple(dbot.shape) != (S.shape[0], S.shape[2])):
        raise ValueError(f"blocked_qr_r: expected (B, D, N) and (B, N), got {tuple(S.shape)}, "
                         f"{None if dbot is None else tuple(dbot.shape)}")
    B, D, N = S.shape
    rows = D + (N if dbot is not None else 0)
    if rows < N:
        raise ValueError(f"blocked_qr_r: expected (B, D, N) with D >= N, got {tuple(S.shape)}")
    if S.dtype not in _WIDE_DTYPES:
        raise TypeError(f"blocked_qr_r: dtype {S.dtype} (the kernel takes float32 or float64)")
    if B == 0 or N == 0:
        return torch.zeros((B, N, N), dtype=S.dtype, device=S.device)
    if _on_cpu(S):
        return blocked_qr_r_plain(S if dbot is None else torch.cat([S, torch.diag_embed(dbot)], dim=-2))
    _require_cuda("blocked_qr_r", S, *(() if dbot is None else (dbot,)), dtypes=_WIDE_DTYPES)
    plan = blocked_qr_plan(rows, N, S.dtype)
    if plan is None:
        raise ValueError(f"blocked_qr_r: an instance of {rows} rows does not fit in a cluster's shared memory")
    C, bw, block_rows, ld = plan
    R = torch.empty((B, N, N), dtype=S.dtype, device=S.device)
    # The finished Q panels, all but the last, column-major over the
    # cluster's padded rows; each block writes and reads its own rows.
    ws = torch.empty((B, (-(-N // bw) - 1) * bw * C * block_rows), dtype=S.dtype, device=S.device)
    _launch("blocked_qr_r", "benlsip_blocked_qr_r", S, S.data_ptr(), None if dbot is None else dbot.data_ptr(),
            R.data_ptr(), ws.data_ptr(), B, D, N, C, block_rows, ld)
    return R


# ---------------------------------------------------------------------------
# Fused call sites: masked Gram + Cholesky, masked tangent projection
# ---------------------------------------------------------------------------


def has_row_major_blocks(A: Tensor) -> bool:
    """True when every (m, n) block of A (B, m, n) is row-major contiguous,
    whatever the batch stride: a stride-0 expand of one matrix qualifies."""
    _, m, n = A.shape
    return (n == 1 or A.stride(2) == 1) and (m == 1 or A.stride(1) == n)


def _cluster_blocks(n: int) -> int:
    """The split form's blocks per instance for n ≥ SPLIT_MIN_N columns."""
    S = 2
    while S < MAX_CLUSTER and S * SPLIT_THREADS < n:
        S *= 2
    return S


def fused_plan(M: int, n: int, dtype: torch.dtype) -> int:
    """Blocks per instance of the fused kernels for an (M, n) instance of
    `dtype`: 1 is the warp form (one warp per instance), S ≥ 2 the split form
    (a cluster of S blocks per instance).  A function of the shape only,
    never of the batch: a lane's summation tree, and so its bits, must not
    depend on the batch it runs in (compaction's bit-identity).  M and
    dtype do not move it at the shapes measured (PERF.md)."""
    return 1 if n < SPLIT_MIN_N else _cluster_blocks(n)


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
    if A.dtype == torch.bfloat16:
        return _rounded_from_f32(masked_aat_cholesky_plain, A, fixed, reg)
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
    n = A.shape[2]
    _launch(
        "masked_aat_cholesky", "benlsip_masked_aat_cholesky", A,
        A.data_ptr(), stride, fixed.data_ptr(), float(reg), L.data_ptr(), B, M, n, plan=fused_plan(M, n, A.dtype),
    )
    return L


def project_tangent_plain(A: Tensor, L: Tensor, fixed: Tensor, r: Tensor, unmasked_output: bool = False) -> Tensor:
    """Plain PyTorch twin of the fused projection kernel: mask, A Z r, the
    plain Cholesky solve, Aᵀw, mask, subtract."""
    if A.dtype == torch.bfloat16:
        return _rounded_from_f32(project_tangent_plain, A, L, fixed, r, unmasked_output)
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
        B, M, n, int(unmasked_output), plan=fused_plan(M, n, A.dtype),
    )
    return out


# ---------------------------------------------------------------------------
# The dual Newton of the polyhedral projection
# ---------------------------------------------------------------------------

_NEWTON_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROW_POWS = 60   # the kernel's bracket holds 2^0 .. 2^60


def newton_plan(M: int, n: int, dtype: torch.dtype) -> int:
    """Layout of the dual-Newton kernel for an (M, n) instance: 0 the warp
    form with the line search's grid points on the lanes (n ≤
    NEWTON_LANES_MAX_N), 1 the warp form with the columns on the lanes, S ≥ 2
    a cluster of S blocks per instance (n ≥ SPLIT_MIN_N, the fused kernels'
    cluster sizes).  A function of the shape only, never of the batch, so
    that a lane's bits do not depend on the batch it runs in."""
    if n >= SPLIT_MIN_N:
        return _cluster_blocks(n)
    return 0 if n <= NEWTON_LANES_MAX_N else 1


def _check_newton(A, b, l, u, x, lam0, active, max_iter, grow_pows, n_section) -> None:
    """Refuse, on either device, an operand the dual-Newton kernel does not
    take: wrong shapes, a dtype other than float32 or bfloat16, mixed dtypes
    or devices, a non-contiguous vector, m outside 1..MAX_DIM."""
    if A.ndim != 3:
        raise ValueError(f"polyhedron_newton: expected A (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    want = {"b": (b, (B, m)), "l": (l, (B, n)), "u": (u, (B, n)), "x": (x, (B, n)),
            "lam0": (lam0, (B, m)), "active": (active, (B,))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"polyhedron_newton: {name} has shape {tuple(t.shape)}, expected {shape}")
    floats = [t for t in (A, b, l, u, x, lam0) if t is not None]
    if x.dtype not in _NEWTON_DTYPES:
        raise TypeError(f"polyhedron_newton: dtype {x.dtype} (the kernel takes float32 or bfloat16)")
    if any(t.dtype != x.dtype for t in floats):
        raise TypeError(f"polyhedron_newton: mixed dtypes {sorted({str(t.dtype) for t in floats})}")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"polyhedron_newton: active must be bool, got {active.dtype}")
    if any(t.device != x.device for t in floats + ([active] if active is not None else [])):
        raise ValueError("polyhedron_newton: all tensors must share one device")
    if not all(t.is_contiguous() for t in floats[1:] + ([active] if active is not None else [])):
        raise ValueError("polyhedron_newton: b, l, u, x, lam0 and active must be contiguous")
    if not has_row_major_blocks(A):
        raise ValueError(f"polyhedron_newton: A needs row-major (m, n) blocks, got strides {A.stride()}")
    if not 0 < m <= MAX_DIM:
        raise ValueError(f"polyhedron_newton: need 0 < m <= {MAX_DIM}, got m={m}")
    if not (0 <= grow_pows <= MAX_GROW_POWS and n_section >= 0 and max_iter >= 0):
        raise ValueError(f"polyhedron_newton: need 0 <= grow_pows <= {MAX_GROW_POWS}, n_section >= 0 and "
                         f"max_iter >= 0, got {grow_pows}, {n_section}, {max_iter}")


# The dual Newton's plain version is the masked loop of `ops/polyproject`,
# a layer above this module; that module registers it here when it is
# imported (the package imports it), so nothing here imports from `ops/`.
_NEWTON_PLAIN = None


def set_newton_plain(fn) -> None:
    """Register the dual-Newton kernel's plain version, the function the
    wrapper runs on CPU tensors (`ops/polyproject.newton_plain`)."""
    global _NEWTON_PLAIN
    _NEWTON_PLAIN = fn


def polyhedron_newton(A: Tensor, b: Tensor, l: Tensor, u: Tensor, x: Tensor, tol: float, reg: float,
                      max_iter: int, grow_pows: int, n_section: int, lam0=None, active=None):
    """Project each lane's x onto {v : A v = b, l ≤ v ≤ u} by the dual
    Newton of `ops/polyproject`, each lane to its own exit: A (B, m, n),
    b (B, m), l, u, x (B, n), warm start lam0 (B, m) or None (cold), bool
    active (B,) or None (every lane) -> (v (B, n), λ (B, m), trips (B,)
    int32).  A lane not active runs no trip and returns v = clip(x − Aᵀλ₀,
    l, u), λ = λ₀.  A may share one matrix across the batch (stride 0)."""
    _check_newton(A, b, l, u, x, lam0, active, max_iter, grow_pows, n_section)
    B, m, n = A.shape
    if B == 0:
        return torch.empty_like(x), torch.zeros_like(b), torch.zeros((0,), dtype=torch.int32, device=x.device)
    if _on_cpu(x):
        if _NEWTON_PLAIN is None:
            raise RuntimeError("polyhedron_newton: no plain version registered (import benlsip_tpu_torch.ops.polyproject)")
        return _NEWTON_PLAIN(A, b, l, u, x, tol, reg, max_iter, grow_pows, n_section, lam0, active)
    if n == 0:
        raise ValueError("polyhedron_newton: n = 0 has no column to project")
    v, lam = torch.empty_like(x), torch.empty_like(b)
    iters = torch.empty((B,), dtype=torch.int32, device=x.device)
    ws = torch.empty((B, 2, n), dtype=torch.float32, device=x.device)   # z and w of each column
    _launch(
        "polyhedron_newton", "benlsip_polyhedron_newton", x,
        A.data_ptr(), A.stride(0) if B > 1 else 0, b.data_ptr(), l.data_ptr(), u.data_ptr(), x.data_ptr(),
        None if lam0 is None else lam0.data_ptr(), None if active is None else active.data_ptr(),
        float(tol), float(reg), int(max_iter), int(grow_pows), int(n_section),
        v.data_ptr(), lam.data_ptr(), iters.data_ptr(), ws.data_ptr(), B, m, n, plan=newton_plan(m, n, x.dtype),
    )
    return v, lam, iters


# ---------------------------------------------------------------------------
# The minor iteration on the materialized operator R
# ---------------------------------------------------------------------------


def minor_direction_smem(k: int, m: int, n: int) -> int:
    """Bytes of dynamic shared memory of the minor-iteration kernel's block
    for R (k, n) and m equalities: R, A's rows, L, p, the projected vector
    and its projection, R p, the reductions and the mask.  Every launch
    passes it to the C entry, which refuses it unless it equals its own
    `smem_bytes`."""
    return 4 * (k * n + m * n + m * m + 3 * n + k + MINOR_RED_FLOATS) + n


def minor_direction_fits(k: int, m: int, n: int) -> bool:
    """Whether the minor-iteration kernel takes R (k, n) with m equalities:
    0 < m ≤ MAX_DIM, 0 < n ≤ MINOR_THREADS, k > 0 and the block's shared
    memory (`minor_direction_smem`) within MAX_DYNAMIC_SMEM — at k = n,
    n ≤ 230 for every m ≤ 16 (n ≤ 235 at m = 6)."""
    return (0 < m <= MAX_DIM and 0 < n <= MINOR_THREADS and k > 0
            and minor_direction_smem(k, m, n) <= MAX_DYNAMIC_SMEM)


def unit_rows(t: Tensor) -> Tensor:
    """A (B, n) operand as the minor-iteration kernel reads it: rows of
    unit stride at any batch stride, so a stride-0 expand of one row (the
    shared bounds of a batch) stays a view; anything else is copied."""
    return t if t.shape[-1] == 1 or t.stride(-1) == 1 else t.contiguous()


# The minor iteration's plain version is `solver/inner`'s composition of
# `projected_cg` and `linesearch`, layers above this module; that module
# registers it here when it is imported (the package imports it), so
# nothing here imports solver code.
_MINOR_PLAIN = None


def set_minor_plain(fn) -> None:
    """Register the minor-iteration kernel's plain version, the function the
    wrapper runs on CPU tensors (`solver/inner.minor_direction_r_plain`)."""
    global _MINOR_PLAIN
    _MINOR_PLAIN = fn


def _check_minor(R, A, L, fixed, x, s, g, xl, xu, delta, active, name="minor_direction_r", g_minor=None,
                 max_minor=None) -> None:
    """Refuse, on either device, an operand a minor-iteration kernel (`name`)
    does not take: wrong shapes, a dtype other than float32 (int32 for
    `max_minor`), mixed devices, a layout it cannot read, or a shape outside
    `minor_direction_fits`."""
    if R.ndim != 3 or A.ndim != 3:
        raise ValueError(f"{name}: expected R (B, k, n) and A (B, m, n), got {tuple(R.shape)}, {tuple(A.shape)}")
    B, k, n = R.shape
    m = A.shape[1]
    want = {"A": (A, (B, m, n)), "L": (L, (B, m, m)), "fixed": (fixed, (B, n)), "x": (x, (B, n)), "s": (s, (B, n)),
            "g": (g, (B, n)), "g_minor": (g_minor, (B, n)), "xl": (xl, (B, n)), "xu": (xu, (B, n)),
            "delta": (delta, (B,)), "active": (active, (B,)), "max_minor": (max_minor, (B,))}
    for key, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
    floats = tuple(t for t in (R, A, L, x, s, g, g_minor, xl, xu, delta) if t is not None)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: dtypes {sorted({str(t.dtype) for t in floats})} (the kernel takes float32)")
    if fixed.dtype != torch.bool or (active is not None and active.dtype != torch.bool):
        raise TypeError(f"{name}: fixed and active must be bool")
    if max_minor is not None and max_minor.dtype != torch.int32:
        raise TypeError(f"{name}: max_minor must be int32, got {max_minor.dtype}")
    others = tuple(t for t in (fixed, active, max_minor) if t is not None)
    if any(t.device != R.device for t in floats + others):
        raise ValueError(f"{name}: all tensors must share one device")
    dense = tuple(t for t in (R, L, x, s, g, g_minor, delta) if t is not None) + others
    if not all(t.is_contiguous() for t in dense):
        raise ValueError(f"{name}: R, L, fixed, x, s, g, g_minor, delta, active and max_minor must be contiguous")
    if not has_row_major_blocks(A) or any(unit_rows(t) is not t for t in (xl, xu)):
        raise ValueError(f"{name}: A needs row-major (m, n) blocks and xl, xu rows of unit stride, got "
                         f"strides {A.stride()}, {xl.stride()}, {xu.stride()}")
    if not minor_direction_fits(k, m, n):
        raise ValueError(f"{name}: R ({k}, {n}) with m = {m} is outside the kernel "
                         f"({minor_direction_smem(k, m, n)} B of shared memory, n ≤ {MINOR_THREADS}, 0 < m ≤ {MAX_DIM})")


def minor_direction_r(R: Tensor, A: Tensor, L: Tensor, fixed: Tensor, x: Tensor, s: Tensor, g: Tensor, xl: Tensor,
                      xu: Tensor, delta: Tensor, kappa2: float, active=None):
    """One minor iteration of `solver/inner.minor_iterate` on the
    Gauss-Newton operator H = RᵀR, each lane to its own exit: the box of
    the free variables from x, s, delta and [xl, xu], the projected CG from
    g (kappa2 its relative tolerance) with the tangent projection of A and
    its masked factor L, the model line search, and the step scaled unless
    the CG met negative curvature.  R (B, k, n), A (B, m, n), L (B, m, m),
    bool fixed (B, n), x, s, g, xl, xu (B, n), delta (B,), bool active (B,)
    or None (every lane) -> (w (B, n), CG status (B,) int32, CG trips (B,)
    int32).  A lane not active runs no trip and returns w = 0, its entry
    status and 0 trips, as the plain version does.  A and the bounds may be
    shared by the batch (stride 0)."""
    _check_minor(R, A, L, fixed, x, s, g, xl, xu, delta, active)
    B, k, n = R.shape
    m = A.shape[1]
    if B == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=x.device)
        return torch.zeros_like(x), empty, empty.clone()
    if _on_cpu(x):
        if _MINOR_PLAIN is None:
            raise RuntimeError("minor_direction_r: no plain version registered (import benlsip_tpu_torch.solver.inner)")
        return _MINOR_PLAIN(R, A, L, fixed, x, s, g, xl, xu, delta, kappa2, active)
    w = torch.empty_like(x)
    status = torch.empty((B,), dtype=torch.int32, device=x.device)
    iters = torch.empty((B,), dtype=torch.int32, device=x.device)

    def batch_stride(t: Tensor) -> int:
        return t.stride(0) if B > 1 else 0

    _launch(
        "minor_direction_r", "benlsip_minor_direction_r", x,
        R.data_ptr(), A.data_ptr(), batch_stride(A), L.data_ptr(), fixed.data_ptr(), x.data_ptr(), s.data_ptr(),
        g.data_ptr(), xl.data_ptr(), batch_stride(xl), xu.data_ptr(), batch_stride(xu), delta.data_ptr(),
        None if active is None else active.data_ptr(), float(kappa2), torch.finfo(torch.float32).eps ** 0.5,
        MINOR_BOUND_ATOL, w.data_ptr(), status.data_ptr(), iters.data_ptr(), B, k, m, n,
        minor_direction_smem(k, m, n),
    )
    return w, status, iters


# The minor loop's plain version is `solver/inner`'s masked loop over
# `minor_iterate`, registered here when that module is imported.
_MINOR_LOOP_PLAIN = None


def set_minor_loop_plain(fn) -> None:
    """Register the minor-loop kernel's plain version, the function the
    wrapper runs on CPU tensors (`solver/inner.minor_loop_r_plain`)."""
    global _MINOR_LOOP_PLAIN
    _MINOR_LOOP_PLAIN = fn


def minor_loop_r(R: Tensor, A: Tensor, L: Tensor, fixed: Tensor, x: Tensor, s: Tensor, g: Tensor, g_minor: Tensor,
                 xl: Tensor, xu: Tensor, delta: Tensor, run, max_minor: Tensor, kappa2: float, kappa3: float,
                 atol: float, reg: float = 0.0):
    """The minor loop of `solver/inner.inner_step` on the Gauss-Newton
    operator H = RᵀR, each lane to its own exit (its trips reach
    `max_minor`, its reduced gradient at s is small enough — kappa3 — or
    its CG met negative curvature): each trip one minor iteration (as
    `minor_direction_r`, kappa2 the CG's tolerance), s += w, g_minor =
    H s + g, the bounds hit (within atol) added to the fixed set — or,
    where the union leaves no room for the equalities, the bounds active at
    x + s, and the lane stops — and the set's factor (reg its jitter).
    R (B, k, n), A (B, m, n), the entry carry L (B, m, m), bool fixed (B, n),
    s and g_minor (B, n), x, g, xl, xu (B, n), delta (B,), bool run (B,) the
    lanes that run at entry (None: every lane), int32 max_minor (B,) ->
    (s, g_minor, bool fixed, L, trips (B,) int32, CG trips (B,) int32, the
    last trip's CG status (B,) int32, CG_RUNNING where no trip ran).  A lane
    that does not run returns its entry carry and 0 trips.  A and the bounds
    may be shared by the batch (stride 0)."""
    _check_minor(R, A, L, fixed, x, s, g, xl, xu, delta, run, name="minor_loop_r", g_minor=g_minor,
                 max_minor=max_minor)
    B, k, n = R.shape
    m = A.shape[1]
    if B == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=x.device)
        return s.clone(), g_minor.clone(), fixed.clone(), L.clone(), empty, empty.clone(), empty.clone()
    if _on_cpu(x):
        if _MINOR_LOOP_PLAIN is None:
            raise RuntimeError("minor_loop_r: no plain version registered (import benlsip_tpu_torch.solver.inner)")
        return _MINOR_LOOP_PLAIN(R, A, L, fixed, x, s, g, g_minor, xl, xu, delta, run, max_minor, kappa2, kappa3,
                                 atol, reg)
    s_out, g_minor_out = torch.empty_like(x), torch.empty_like(x)
    fixed_out, L_out = torch.empty_like(fixed), torch.empty_like(L)
    iters, cg_iters, status = (torch.empty((B,), dtype=torch.int32, device=x.device) for _ in range(3))

    def batch_stride(t: Tensor) -> int:
        return t.stride(0) if B > 1 else 0

    _launch(
        "minor_loop_r", "benlsip_minor_loop_r", x,
        R.data_ptr(), A.data_ptr(), batch_stride(A), L.data_ptr(), fixed.data_ptr(), x.data_ptr(), s.data_ptr(),
        g.data_ptr(), g_minor.data_ptr(), xl.data_ptr(), batch_stride(xl), xu.data_ptr(), batch_stride(xu),
        delta.data_ptr(), None if run is None else run.data_ptr(), max_minor.data_ptr(), float(kappa2),
        float(kappa3), torch.finfo(torch.float32).eps ** 0.5, MINOR_BOUND_ATOL, float(atol), float(reg),
        s_out.data_ptr(), g_minor_out.data_ptr(), fixed_out.data_ptr(), L_out.data_ptr(), iters.data_ptr(),
        cg_iters.data_ptr(), status.data_ptr(), B, k, m, n, minor_direction_smem(k, m, n),
    )
    return s_out, g_minor_out, fixed_out, L_out, iters, cg_iters, status
