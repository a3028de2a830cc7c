"""Device time of the panel QR kernel (`blocked_qr_r`), and the warm walls
of config 3, for an A/B of two checkouts on one card.

Run on a machine with a CUDA card, from the root of the checkout under test:

    python3 scripts/blocked_qr_ab.py --parent ../parent [--walls]

runs this script once for each checkout in turns (parent, change, change,
parent; the change is the current directory) and prints each run's JSON
line, then the device µs side by side.  One checkout alone:

    python3 scripts/blocked_qr_ab.py --tag change [--walls] [--stages]

Each run imports the `benlsip_tpu_torch` of its current directory.  Without
`--walls` it builds that checkout's panel QR sources alone (`csrc/blocked_qr*`
and `cholesky.cu`, which holds the error strings, with the checkout's nvcc
flags) and loads them in place of the whole kernel library; with `--walls`
it builds the whole library.  It prints one JSON line: the card, the tag, and
for each shape of `SHAPES` the device µs a call (torch.profiler: every
device kernel over 20 warm calls, over 20) and the CUDA-event ms a call of
`blocked_qr_r`; where the checkout has the stacked form, also
`blocked_qr_r(JZ, dbot)` at the polish's (64, 1024 + 192, 192).  `--walls`
adds the warm walls of config 3 (`dense_quadratic_family(64, n=192, d=1024,
m=6, seed=3)`, chunk 64) with `fuse=True` and without, three each after a
cold call.  `--stages` runs a copy of the checkout's kernel with clock64()
stamps and prints the share of its SM cycles in each stage (the parent of
the cluster form: `scripts/blocked_qr_stages.cu`; the cluster form: a copy
made from its source).  `--check` holds the kernel to its plain version.  Compare two checkouts
only inside one call, since cards and hosts differ between calls.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The rows of the panel QR's table in PERF.md: the polish's shape on config 3
# (built as the polish stacks it), a ragged one, the gate's corners and the
# two corners below its batch bound.
SHAPES = ((64, 1216, 192), (16, 534, 150), (4, 2048, 256), (64, 2048, 256), (1, 1216, 192), (2, 2048, 256))
HERE = Path(__file__).resolve()


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_us(fn, reps: int = 20) -> float:
    """Device time a call of fn: every device kernel of `reps` warm calls
    traced by torch.profiler, over `reps`; a trace that sees no kernel is
    taken again (five times at most), then CUDA events time the calls
    queued behind a stream held by a spin kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(e.self_device_time_total for e in events) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(400 * 2e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def polish_stack(rng, B, d, n, dev):
    """[JZ; D] as the polish builds it (chip_smoke.polish_stack): zero columns
    where a bound is fixed (~20%) over diag(fixed ? 1 : 0)."""
    fixed = rng.random((B, n)) < 0.2
    JZ = rng.standard_normal((B, d, n)) * ~fixed[:, None, :]
    dbot = np.where(fixed, 1.0, 0.0)
    JZ_t = torch.as_tensor(JZ, dtype=torch.float32, device=dev)
    dbot_t = torch.as_tensor(dbot, dtype=torch.float32, device=dev)
    return JZ_t, dbot_t, torch.cat([JZ_t, torch.diag_embed(dbot_t)], dim=-2)


def nvcc_so(kern, sources, name: str, extra=()) -> Path:
    """Compile `sources` with the checkout's nvcc flags (fused multiply-add
    as its build gives each source) into one shared library under its build
    directory, keyed on their contents."""
    h = hashlib.sha256(repr((kern.NVCC_FLAGS, kern.FMAD_SOURCES, extra)).encode())
    for src in sources:
        h.update(src.read_bytes())
    for hdr in sorted(kern.CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    out = kern.BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    kern.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        fmad = f"--fmad={'true' if src.name in kern.FMAD_SOURCES or src.parent != kern.CSRC else 'false'}"
        obj = kern.BUILD_DIR / f"{name}_{src.stem}_{os.getpid()}.o"
        cmd = [kern._nvcc(), *kern.NVCC_FLAGS, fmad, "-I", str(kern.CSRC), *extra, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    for cmd, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{text}")
        spills = [ln.strip() for ln in text.splitlines() if "spill" in ln and not ln.strip().startswith("0 bytes")]
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        print(f"# {Path(cmd[-3]).name}: {len(regs)} kernels; {regs[:8]} {spills[:8]}", file=sys.stderr)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([kern._nvcc(), *kern.NVCC_ARCH, "-shared", "-o", str(tmp), *map(str, objs)], check=True)
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def panel_qr_library(kern) -> None:
    """Load the checkout's panel QR sources alone in place of the kernel library."""
    sources = sorted(kern.CSRC.glob("blocked_qr*.cu")) + [kern.CSRC / "cholesky.cu"]
    lib = ctypes.CDLL(str(nvcc_so(kern, sources, "ab_panel_qr")))
    for suffix in kern._ENTRY_SUFFIXES.get("benlsip_blocked_qr_r", ("f32", "f64")):
        fn = getattr(lib, f"benlsip_blocked_qr_r_{suffix}")
        fn.argtypes = kern._SIGNATURES["benlsip_blocked_qr_r"]
        fn.restype = ctypes.c_int
    lib.benlsip_error_string.argtypes = [ctypes.c_int]
    lib.benlsip_error_string.restype = ctypes.c_char_p
    kern.load_library = functools.lru_cache(maxsize=None)(lambda: lib)
    kern._kernel_fn.cache_clear()


def old_panel_layout(D: int):
    """The parent kernel's (panel width, leading dimension) for D float32
    rows: `qr_panel_layout` of its commit."""
    ld = -(-D // 4) * 4
    ld += (4 - ld) % 32
    return next((bw, ld) for bw in (32, 16, 8) if (bw * ld + 8 * bw * bw + 2 * bw) * 4 <= 232448)


# The stamps of the cluster kernel's copy: (text of csrc/blocked_qr.cu, what
# replaces it).  STAMP(i) adds the SM cycles since the last stamp, after a
# block barrier, to counter i; the column steps add theirs to counters 11-14
# without a barrier (thread 0's view).
CLUSTER_STAGES = ("load", "proj_gram", "proj_reduce", "proj_product", "column_steps", "reorth_gram", "cholesky",
                  "inverse", "q_product", "r2r1", "-", "steps_barrier", "steps_sums", "steps_update", "steps_tail")
CLUSTER_STAMPS = (
    ("int* dpar, T tiny) {\n", "int* dpar, T tiny, long long* mst) {\n"),
    ("    cl.sync();                       // every block's dots of step c are in every block\n",
     "    long long m0 = clock64();\n    cl.sync();\n    long long m1 = clock64(); mst[0] += m1 - m0;\n"),
    ("    if (c + 1 == nc) break;\n    *dpar ^= 1;\n",
     "    if (c + 1 == nc) break;\n    *dpar ^= 1;\n    long long m2 = clock64(); mst[1] += m2 - m1;\n"),
    ("    // The next pivot's own square,", "    long long m3 = clock64(); mst[2] += m3 - m2;\n    // The next pivot's own square,"),
    ("    for (int u = 0; u < kLaneGroups; ++u) piv[u] = nxt[u];\n  }\n",
     "    for (int u = 0; u < kLaneGroups; ++u) piv[u] = nxt[u];\n    mst[3] += clock64() - m3;\n  }\n"),
    ("nrm, dpart, &dpar, tiny);\n", "nrm, dpart, &dpar, tiny, st + 11);\n    STAMP(4)\n"),
    ("int LD, T tiny) {\n", "int LD, T tiny, long long* stamps) {\n"),
    ("  int wpar = 0, dpar = 0;\n",
     "  int wpar = 0, dpar = 0;\n  long long t0 = clock64(), st[15] = {};\n  const long long t_start = t0;\n"
     "#define STAMP(i) { __syncthreads(); const long long t_ = clock64(); st[i] += t_ - t0; t0 = t_; }\n"),
    ('    asm volatile("cp.async.wait_all;" ::: "memory");\n    __syncthreads();\n',
     '    asm volatile("cp.async.wait_all;" ::: "memory");\n    __syncthreads();\n    STAMP(0)\n'),
    ("        gram(qj, ldw, panel, LD, rows, wpart + wpar * BW * WS, wsum);\n",
     "        gram(qj, ldw, panel, LD, rows, wpart + wpar * BW * WS, wsum);\n        STAMP(1)\n"),
    ("        product<true>(qj, ldw, wsum, panel, LD, rows);\n",
     "        STAMP(2)\n        product<true>(qj, ldw, wsum, panel, LD, rows);\n"),
    ("    // 3. Modified Gram-Schmidt inside the panel.\n", "    STAMP(3)\n"),
    ("      cluster_reduce(cl, wpart + wpar * BW * WS, wsum);\n      T* xinv",
     "      cluster_reduce(cl, wpart + wpar * BW * WS, wsum);\n      STAMP(5)\n      T* xinv"),
    ("      const bool ok = block_cholesky(wsum, dpart);", "      const bool ok = block_cholesky(wsum, dpart);\n      STAMP(6)"),
    ("        block_upper_inverse(static_cast<const T*>(wsum), xinv, dpart);\n",
     "        block_upper_inverse(static_cast<const T*>(wsum), xinv, dpart);\n        STAMP(7)\n"),
    ("        product<false>(static_cast<const T*>(panel), LD, xinv, qk, ldw, rows);\n",
     "        product<false>(static_cast<const T*>(panel), LD, xinv, qk, ldw, rows);\n        STAMP(8)\n"),
    ("      __syncthreads();   // the workspace is read back by this block only\n",
     "      __syncthreads();   // the workspace is read back by this block only\n      STAMP(9)\n"),
    ("  cl.sync();             // no block leaves while another reads its shared memory\n}",
     "  cl.sync();\n  if (threadIdx.x == 0 && cl.rank == 0) {\n    for (int i = 0; i < 15; ++i) stamps[16 * inst + i] = st[i];\n"
     "    stamps[16 * inst + 15] = clock64() - t_start;\n  }\n}"),
    ("int LD, void* stream) {\n", "int LD, long long* stamps, void* stream) {\n"),
    ("(S, dbot, R, ws, DS, N, 1, rows, LD, tiny);", "(S, dbot, R, ws, DS, N, 1, rows, LD, tiny, stamps);"),
    ("ws, DS, N, C, rows, LD, tiny));", "ws, DS, N, C, rows, LD, tiny, stamps));"),
)
STAMPED_ENTRY = """}  // namespace

BENLSIP_API int blocked_qr_stages_f32(const float* S, const float* dbot, float* R, float* ws, int B, int D, int N,
                                      int C, int rows, int LD, long long* stamps, void* stream) {
  return launch<float>(S, dbot, R, ws, B, D, N, C, rows, LD, stamps, stream);
}
"""


def stamped_cluster_kernel(kern) -> Path:
    """A copy of the checkout's csrc/blocked_qr.cu with clock64() stamps
    (CLUSTER_STAMPS) and one C entry point (STAMPED_ENTRY) in place of its
    own, under its build directory."""
    src = (kern.CSRC / "blocked_qr.cu").read_text()
    for old, new in CLUSTER_STAMPS:
        if old not in src:
            raise RuntimeError(f"blocked_qr_ab.py --stages: the kernel has no {old[:50]!r}")
        src = src.replace(old, new, 1)
    src = src[:src.index("}  // namespace")] + STAMPED_ENTRY
    out = kern.BUILD_DIR / "blocked_qr_stamped.cu"
    kern.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def stages(kern, rng, dev) -> dict:
    """Share of the kernel's SM cycles in each stage (thread 0 of each
    instance's first block, over the instances), from a stamped copy: the
    parent's from scripts/blocked_qr_stages.cu, a cluster kernel's from
    stamped_cluster_kernel."""
    cluster = hasattr(kern, "blocked_qr_plan")
    src = stamped_cluster_kernel(kern) if cluster else HERE.parent / "blocked_qr_stages.cu"
    lib = ctypes.CDLL(str(nvcc_so(kern, [src], "ab_stages")))
    fn = lib.blocked_qr_stages_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 if cluster else
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    names = CLUSTER_STAGES if cluster else ("load", "project", "mgs", "cholqr")
    out = {}
    for B, D, N in SHAPES:
        S = polish_stack(rng, B, D - N, N, dev)[2] if (D, N) == (1216, 192) else \
            torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
        R = torch.empty((B, N, N), device=dev)
        if cluster:
            C, bw, rows, ld = kern.blocked_qr_plan(D, N, torch.float32)
            ws = torch.empty((B, (-(-N // bw) - 1) * bw * C * rows), device=dev)
            st = torch.zeros((B, 16), dtype=torch.int64, device=dev)
            args = (S.data_ptr(), None, R.data_ptr(), ws.data_ptr(), B, D, N, C, rows, ld)
        else:
            bw, ld = old_panel_layout(D)
            ws = torch.empty((B, (-(-N // bw) - 1) * bw * ld), device=dev)
            st = torch.zeros((B, 5), dtype=torch.int64, device=dev)
            args = (S.data_ptr(), R.data_ptr(), ws.data_ptr(), B, D, N, bw, ld)
        for _ in range(3):
            rc = fn(*args, st.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"stages kernel: cudaError {rc}")
        torch.cuda.synchronize()
        diff = float((R - kern.blocked_qr_r(S)).abs().max())
        cyc = st.double().mean(0).tolist()
        total = cyc[-1]
        out["x".join(map(str, (B, D, N)))] = {
            "max_abs_diff_to_package": diff, "cycles": {n: round(c) for n, c in zip(names, cyc) if n != "-"},
            "share": {n: round(c / total, 4) for n, c in zip(names, cyc) if n != "-"}, "total_cycles": round(total),
        }
    return out


def check(kern, rng, dev) -> dict:
    """The kernel against its plain version on the card: the error over the
    tolerance 4·eps·(√D + κ)·max|R| (κ from the library's R), the chord
    contraction over κ·eps at the conditioned shapes, the stacked form and
    lanes alone or permuted bitwise, NaN and zero-column lanes."""
    eps = float(torch.finfo(torch.float32).eps)
    out = {}

    def cond(B, D, N, kappa):
        U = np.linalg.qr(rng.standard_normal((B, D, N)))[0]
        V = np.linalg.qr(rng.standard_normal((B, N, N)))[0]
        sv = np.logspace(0.0, -math.log10(kappa), N)
        return torch.as_tensor((U * sv) @ np.transpose(V, (0, 2, 1)), dtype=torch.float32, device=dev)

    def contraction(S, R):
        Sd, Rd = S.double(), R.double()
        Ri = torch.linalg.inv(Rd)
        return float(torch.linalg.matrix_norm(Ri.mT @ (Sd.mT @ Sd - Rd.mT @ Rd) @ Ri, ord=2).max())

    cases = {"64x1216x192": polish_stack(rng, 64, 1024, 192, dev)[2]}
    for B, D, N in ((16, 534, 150), (4, 2048, 256), (8, 300, 17), (3, 40, 40), (4, 1540, 70), (1, 300, 40),
                    (6, 200, 80), (2, 3000, 70)):
        cases[f"{B}x{D}x{N}"] = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
    for N in (36, 70, 100, 136):
        for kappa in (1e4, 1e6):
            cases[f"4x300x{N} kappa={kappa:.0e}"] = cond(4, 300, N, kappa)
    for tag, S in cases.items():
        R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
        Rl = torch.linalg.qr(S, mode="r")[1]
        Rl = Rl * torch.where(torch.diagonal(Rl, dim1=1, dim2=2) < 0, -1.0, 1.0).unsqueeze(-1)
        sv = torch.linalg.svdvals(Rl.double())
        kappa = float((sv[:, 0] / sv[:, -1]).max())
        tol = 4 * eps * (math.sqrt(S.shape[1]) + kappa) * float(Rl.abs().max())
        rec = {"vs_plain": float((R - Rp).abs().max()) / tol, "vs_library": float((R - Rl).abs().max()) / tol,
               "upper_positive": bool((torch.diagonal(R, dim1=1, dim2=2) > 0).all() and (torch.tril(R, -1) == 0).all())}
        if "kappa" in tag:
            k = float(tag.split("=")[1])
            rec["contraction"] = [contraction(S, M) / (k * eps) for M in (R, Rp, Rl)]
        out[tag] = rec
    JZ, dbot, S = polish_stack(rng, 64, 1024, 192, dev)
    R = kern.blocked_qr_r(S)
    perm = torch.as_tensor(rng.permutation(64), device=dev)
    out["stacked_bitwise"] = bool(torch.equal(kern.blocked_qr_r(JZ, dbot), R))
    out["permuted_bitwise"] = bool(torch.equal(kern.blocked_qr_r(S[perm].contiguous()), R[perm]))
    out["alone_and_4_bitwise"] = all(torch.equal(kern.blocked_qr_r(S[b:b + 1].contiguous()), R[b:b + 1])
                                     and torch.equal(kern.blocked_qr_r(S[b:b + 4].contiguous()), R[b:b + 4])
                                     for b in (0, 30, 60))
    S = torch.as_tensor(rng.standard_normal((6, 200, 80)), dtype=torch.float32, device=dev)
    S[1, :, 5] = 0.0
    S[2, :, 70] = 0.0
    S[4, 17, 3] = float("nan")
    R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
    ok = [0, 1, 2, 3, 5]
    out["zero_nan"] = {"floor": [float(R[1, 5, 5]), float(R[2, 70, 70])], "finite": bool(torch.isfinite(R[ok]).all()),
                       "nan_lane": bool(torch.isnan(R[4]).any()), "vs_plain": float((R[ok] - Rp[ok]).abs().max())}
    for B, D, N in ((4, 600, 50), (3, 2048, 40), (2, 300, 100)):
        S = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float64, device=dev)
        out[f"f64 {B}x{D}x{N}"] = float((kern.blocked_qr_r(S) - kern.blocked_qr_r_plain(S)).abs().max())
    return out


def walls(dev) -> dict:
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.kernels import batched_linalg as kern
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    bp, th, X0 = dense_quadratic_family(64, n=192, d=1024, m=6, seed=3, dtype=torch.float64, device=dev)
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    out = {}
    for tag, kw in (("fused", {"fuse": True}), ("unfused", {})):
        kern.reset_launches()
        t0 = time.perf_counter()
        X, _, info = solve_mixed_precision(bp, th, X0, opts, chunk=64, **kw)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = kern.LAUNCHES["blocked_qr_r"] + kern.CAPTURED["blocked_qr_r"]
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            X, _, info = solve_mixed_precision(bp, th, X0, opts, chunk=64, **kw)
            torch.cuda.synchronize()
            warm.append(round(time.perf_counter() - t0, 4))
        out[tag] = {"cold_s": round(cold, 3), "warm_s": warm, "certified": int(info.converged.sum()),
                    "max_pix": float(info.pix.max()), "blocked_qr_r_cold": launches}
    return out


def run_one(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("blocked_qr_ab.py: no CUDA device")
    sys.path.insert(0, os.getcwd())   # the checkout timed is the current directory's
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    if args.walls:
        kern.build()
        kern.load_library()
    else:
        panel_qr_library(kern)
    if args.build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    dev = torch.device("cuda:0")
    stacked = "dbot" in kern.blocked_qr_r.__code__.co_varnames
    res = {"tag": args.tag, "card": card(), "device_us": {}, "event_ms": {}}
    if args.check:
        res["check"] = check(kern, rng, dev)
        print(json.dumps(res["check"], indent=1), flush=True)
    for B, D, N in SHAPES:
        key = f"{B}x{D}x{N}"
        if (D, N) == (1216, 192):
            JZ, dbot, S = polish_stack(rng, B, D - N, N, dev)
            if stacked:
                res["device_us"][key + "_stacked"] = device_us(lambda: kern.blocked_qr_r(JZ, dbot))
        else:
            S = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
        res["device_us"][key] = device_us(lambda: kern.blocked_qr_r(S))
        res["event_ms"][key] = event_ms(lambda: kern.blocked_qr_r(S))
    if args.stages:
        res["stages"] = stages(kern, rng, dev)
    if args.walls:
        res["walls"] = walls(dev)
    print(json.dumps(res))


def run_turns(args) -> None:
    change, parent = Path.cwd(), Path(args.parent).resolve()
    flags = ["--walls"] if args.walls else []
    # Build both checkouts at once, then time them in turns.
    builds = [subprocess.Popen([sys.executable, str(HERE), "--tag", "build", "--build-only", *flags], cwd=d)
              for d in (parent, change)]
    if any(p.wait() for p in builds):
        raise SystemExit("blocked_qr_ab.py: a build failed")
    runs = []
    for tag, where in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, str(HERE), "--tag", tag, *flags], cwd=where, capture_output=True,
                             text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise SystemExit(f"blocked_qr_ab.py: the {tag} run failed ({out.returncode})")
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(f"device us a call, change [parent] in turns ({runs[0]['card']}):")
    for key in runs[1]["device_us"]:
        new = [r["device_us"][key] for r in runs if r["tag"] == "change"]
        old = [r["device_us"].get(key, math.nan) for r in runs if r["tag"] == "parent"]
        print(f"  {key}: {min(new):.2f}-{max(new):.2f} [{min(old):.2f}-{max(old):.2f}], x{min(old) / max(new):.2f}-{max(old) / min(new):.2f}")
    if args.walls:
        for path in ("fused", "unfused"):
            print(f"  config3-b64 {path} warm s: " + ", ".join(f"{r['tag']} {r['walls'][path]['warm_s']}" for r in runs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", help="time the current directory's checkout alone under this tag")
    ap.add_argument("--parent", help="the parent's checkout: time it and the current directory's in turns")
    ap.add_argument("--walls", action="store_true", help="also config 3's warm walls (builds the whole library)")
    ap.add_argument("--stages", action="store_true", help="also the stage split from a stamped copy of the kernel")
    ap.add_argument("--check", action="store_true", help="also the kernel against its plain version")
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.parent:
        run_turns(args)
    elif args.tag:
        run_one(args)
    else:
        ap.error("give --tag or --parent")


if __name__ == "__main__":
    main()
