"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 is off;
2. build the CUDA kernels of benlsip_tpu_torch from csrc/ (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card,
   in float32, at every path's shapes (batches of one included, config
   5's polish QR at 16,384 instances) and the
   kernel tests' shapes, with
   the NaN, positive-diagonal, empty-batch and refused-operand checks; the
   narrow QR also in its R-only form (`narrow_qr_r`) and its stacked form
   (R of [JZ; diag(dbot)], the polish's factor) bitwise equal to the full
   R of the same matrix, lanes alone and a permuted batch bitwise equal to
   the batch's, NaN and a zero column in one lane, and at the gate's
   corners (4 and 64 instances of 2048 x 16: the wide form); the
   two fused kernels also with a batch-shared (stride-0) A, ragged n,
   degenerate lanes and reg > 0, and against the call site they replace;
   the panel QR kernel also against `torch.linalg.qr` and SᵀS, at the
   polish's shape, ragged panels, clusters of 1, 2 and 4 blocks, κ = 1e4
   and float64, a zero column in a reused panel (its CholeskyQR step keeps
   R₂ = I), and at (4, 300, 36/40/48/70/100/136) with κ = 1e4, 1e5 and 1e6
   (ragged last panels) the chord contraction ‖R⁻ᵀ(SᵀS − RᵀR)R⁻¹‖₂ ≤
   2·κ·eps of the kernel and of its plain version, printed beside the
   library R's, and over the 40 seeded draws of
   scripts/blocked_qr_contraction.py at (4, 300, 36), κ = 1e5 and 1e6; its
   stacked form (R of [JZ; diag(dbot)] from JZ and dbot) bitwise equal to
   the R of the materialized stack at the polish's (64, 1024 + 192, 192)
   and at (5, 301 + 70, 70), and an instance's R alone, in a batch of 4
   and in a permuted batch of 64 bitwise the batch's;
   the fused kernels' split form (a thread-block cluster per instance, the
   plan of `fused_plan` for large n) also at config 4's (1, 8, 10240) with
   the degenerate pair, a shared A, ragged n, n = 40,960, m = 16, float64
   and bf16, lane by lane against the same lane run alone and call against
   call (bitwise);
   the dual-Newton kernel `polyhedron_newton` (the whole loop of
   `ops/polyproject` in one launch) against its plain version (that loop on
   the card) at the paths' shapes (512×1×3, 64×6×192 with a shared A,
   1×1×3, 1×8×10240, 1×8×1024 and 1×8×2048 in the split form; 512×1×3 and
   64×6×192 in bf16),
   cold, warm, warm from a stale dual that sends plain lanes into the cold
   restart, with a third of the lanes inactive and a degenerate lane: v
   within 1e-4·(1 + ‖x‖∞) where both converge, ‖F‖ ≤ tol wherever the
   plain loop converges, no NaN the plain version lacks, the histogram of
   trip-count differences printed; a lane alone bitwise equal to the same
   lane in its batch, two calls bitwise equal, refused operands;
   then, taken in turns inside this one process (plain, kernel, library,
   library, kernel, plain; CUDA events over 200 calls, 20 for the panel
   QR), the time of every kernel, of its plain version and of the one
   PyTorch call that computes the same function (for a fused kernel: of the
   call site it replaces, with the old kernel inside), beside the bound
   computed from the shapes; the fused kernels' split form, warp form and
   old call site in turns at n from 192 to 40,960 and at (130, 3, 5000),
   with each form's device time a call from torch.profiler at every
   cluster size (at (1, 8, 10240) the split form must beat the old call
   site in every turn and take at most a tenth of the warp form's device
   time); the dual-Newton kernel in turns with its plain loop at each
   path's shape, with its device µs a call and the bound from the run's
   trips; the narrow QR's three forms at every path's shape and the gate's
   corners, with the plain version and `torch.linalg.qr`, and by device µs
   a call; the dual Newton's layouts (the grid on the lanes against the columns on the
   lanes at n from 3 to 32; the split form against one warp at 1×8×10240)
   by device µs; the panel QR also by device µs a call at every shape it is
   timed at, and its stacked form in turns with the materialized stack;
   the fused kernels' warp forms by device µs a call at config 2's and
   config 3's shapes;
3c. the minor-iteration kernel `minor_direction_r` (a whole minor
   iteration of solver/inner on the materialized R operator, one launch)
   against its plain version (the composition of solver/cg on the card) at
   config 3's 64×192×192 (m = 6), one lane alone and the gate's corners
   (the largest square R at m = 6 and 16, one row of R at 256 columns, an
   R of an odd number of floats): every CG exit and inactive lanes, the
   same CG status on every lane, w within MINOR_W_RTOL of the lane's
   ‖w‖∞ where the trip counts agree (else against the float64 plain
   version), a lane alone bitwise its lane in the batch, two calls bitwise
   equal; directions of ~1e-5 (below the curvature test's sqrt(eps))
   against a box of 1e-6, where the box still binds; then on config 3's
   real inputs, the minor iterations of `solve_mixed_precision`'s float32
   bulk and the last 30 of a float32 solve run on towards its criticality
   tolerance (the solves' minor loops run again through the loop's plain
   version, whose trips launch this kernel); refused operands; then by
   device µs a call beside its bound, in turns with the same call in a
   graph, the old site (the plain version captured as the fused bulk
   captures it: its CG loop a WHILE node) in a graph, with the device
   operations each replay runs, and the plain version eagerly; then the
   minor-loop kernel `minor_loop_r` (the whole minor loop of an inner step,
   one launch) against its plain version (the masked loop, each trip one
   `minor_direction_r` launch) on both benchmark cells' recorded inputs
   (`densequad-b64-fused`, `densesphere-b64-fused`: each cell's eager
   pipeline on its pool's first batch), as recorded and with every other
   lane held back: the lanes on the plain version's path (trips, CG status,
   fixed set) with s within MINOR_LOOP_S_RTOL, at most a tenth of them off
   it and held to the model reduction; L bitwise the masked_aat_cholesky
   kernel's factor of the returned set, lanes not run bitwise their entry
   carry, two calls and a lane alone bitwise equal; refused operands; and by
   device µs a launch at each cell's call with the most trips, beside its
   bound, in turns with the old site (the plain version in a graph: the
   minor WHILE node) with the device operations each replay runs;
4. the config-2 path: `solve_mixed_precision` on
   `exp_fit_family(1024, d=32, seed=42)` (float64 master data) on cuda:0,
   with every kernel's launch count read around that run (the dual Newton
   is `polyhedron_newton`, so `batched_cho_solve` must launch 0 times);
   1024/1024 must certify at max(pix) ≤ sqrt(eps(f64)) ≈ 1.49e-8, the
   independent numpy KKT oracle must agree on 128 sampled instances, and a
   small batch must agree with the port's CPU run (the plain versions);
   host syncs of the warm call and the device kernels of a traced warm run
   beside the counts before the dual-Newton kernel (both must be lower);
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
   wall is split into bulk and certification; then CholeskyQR2 at
   (8, 1030, 192) with one lane's refinement forced to break down, captured
   into a graph (the explicit rescue behind an IF node) against eager: the
   healthy lanes bitwise equal; then config 3 with `fuse=True`
   (`batch/fused_small.py`: the bulk with its CholeskyQR2 builds, the
   rebuild on acceptance and the rescues behind conditional IF nodes, and
   the certification as CUDA graphs), cold and warm: 64/64 certified at
   ≤ 1.49e-8, the oracle on all 64, within rtol 1e-6 / atol 1e-8 of the
   unfused run and of the same stages run eagerly, every path kernel (the
   panel QR included) captured and run by the replays, no kernel launched
   outside the graphs in a warm call unless a lane goes to the fallback
   refine; host syncs per warm call, capture and instantiate seconds, the
   IF branches taken and the operator builds the replays ran beside the
   eager stages' builds, 5 warm walls of each route in turns, and with
   `--profile` one traced warm unfused call's busy share; then the
   benchmark cells' `device_ops_per_call` (`densequad-b64-fused`, then
   `densesphere-b64-fused`) split part by part of the graphs
   (`phase_bulk_split(cell)`: each WHILE and IF body's nodes a trip times
   its trips a call, by launch name, over the cell's pool), with each minor
   kernel's launches a call equal to the runs of the parts that launch it
   (`minor_loop_r` once an inner step, `minor_direction_r` 0); neither
   minor kernel launches on configs 2 and 4;
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
   (1, 8, 10240) and (1, 8) in phase 3), the fused ones in their split
   form; two warm calls with the fused kernels in their warp form, in turns
   with the two warm calls; one traced warm call: busy share, the Gram GEMM
   and the two fused kernels by name; then the explicit-collective path
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
9. the reduced-precision bulk: the five small kernels' bf16
   instantiations against their bf16 plain versions (the float32 plain
   version on the upcast inputs, rounded once) at every bf16 path's shape
   and the kernel tests' shapes, NaN and refused operands included, within
   one bf16 ulp plus the float32 kernel's slack, with the largest
   difference in ulps; their times in turns (bf16 kernel, float32 kernel,
   plain version, library round trip, and back) beside a bound in bf16
   bytes; then `bulk_dtype=torch.bfloat16` on config 2 cold and warm
   (1024/1024 certified at ≤ 1.49e-8, the oracle on 128, X within rtol 1e-7
   / atol 1e-8 of the float32-bulk run, bf16 launches of the fused kernels
   and the solve, lanes certified by the first polish from either start and
   lanes sent to the f64 refine, 5 warm walls of each in turns, compaction
   against the plain bf16 route), `sphere_family(1024)` with
   `certify="host"` (every lane the float32 bulk certifies certified, bf16
   QR launches), config 3 in bf16 (64/64, only `cholqr2/bfloat16` operator
   builds in the bulk) and config 3 with `bulk_matmul_precision="default"`
   (TF32 in the bulk only: 64/64, lanes certified by the polish and sent
   to the f64 refine beside "highest", TF32 off after the call);
10. the surface ported last: a float64 `solve` of the sphere fixture
   with `verbose=True` into a buffer (the banner, one table per outer
   iteration, one row per inner iteration, the solve unchanged, one host
   sync per line written and none more), `fuse=True` with `verbose=True`
   refused (`ValueError`), `ops/native_qp` on config 2's 1,024 polyhedra
   against the device projection (≤ 1e-8), and
   `ill_conditioned_family(64, n=100, kappa=1e4)`: the float32 bulk, the
   split polish with the QR factor (the panel QR kernel at (64, 484, 100),
   a 4-column last panel) and with the LU, and the all-f64 polish; the QR
   route must certify the f64 polish's set, with the LU's count beside it;
   with `--profile`, also `solve_mixed_precision` on the family once
   (config 3's options): its certified count and wall (minutes: the f64
   refine of the lanes the polish leaves);
11. `polish_then_refine`'s routes at full width, each cold after one
   float32 bulk: on config 2 the host route's split polish
   (`split="on"`: `narrow_qr_r` on the card, f64 chord steps on the CPU),
   its all-f64 polish (`split="off"`: no kernel), the all-f64 polish on
   the card (`split="off"`) with `kkt_factorization="lu"` and `"qr"`, and
   the default fused polish: 1024/1024 certified at ≤ 1.49e-8 each, X
   within rtol 1e-6 / atol 1e-8 of the default route's, the oracle on 128;
   on config 3 the all-f64 polish on the card with LU and QR, the split
   polish on the host route (`blocked_qr_r`'s stacked form) and the fused
   polish with four lanes sent back to their cold start, `num_steps=2,
   rounds=1` and `fallback_device="cpu"` (those lanes refined on the CPU,
   every returned tensor on the CPU): 64/64 each, the oracle on all 64;
   each route's wall, certified count and launches;
12. with `--profile` only: each path's warm wall split into bulk and
   certification, how many lanes the fused polish certifies alone and with
   its re-polish buckets, and the device's busy share and kernel count from
   torch.profiler, with the time and calls of cuSOLVER's `geqr2*` and of
   the panel QR kernel; the fused config-2 path's device span (CUDA
   events), its device kernels (exact, from the graphs) and its busy share
   (the device time of the same stages traced eagerly, over the fused
   wall) beside the unfused path's; for config 5 the same split, and the
   compacted bulk's wall
   and one traced compacted run.

It imports nothing of JAX and nothing of the JAX package: the KKT oracle
is the port's own copy.  The last two lines are the kernels' JSON record
(launch counts per path, bf16 launches per bf16 path, times, bounds; the
shapes the paths called the dual-Newton kernel at, recorded from phases
4-11, whose layouts phase 3 must have checked; phase 11's launches per
route) and the result JSON.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
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

# Published peaks of the H100 SXM, for the bounds: device memory rate, the
# float32 rate outside the tensor cores and the TF32 rate of the tensor cores
# (which the panel QR's products use).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12      # dense TF32 on the tensor cores (the panel QR's 3xTF32 products)

# The kernels on each path; `batched_cholesky` runs there inside
# `masked_aat_cholesky`, which holds its body, and `batched_cho_solve`
# inside `project_tangent` and `polyhedron_newton` (the dual Newton of
# `ops/polyproject`, where every float32 path called it).  Config 3 (n = 192)
# also runs the panel QR kernel; config 2 (n = 3) has no wide QR.
PATH_KERNELS = ("masked_aat_cholesky", "project_tangent", "polyhedron_newton", "batched_thin_qr")
# Configs 1, 2 and 5 (n = 3) also factor the polish's [JZ; D] by the narrow
# QR's R-only form, one launch of `narrow_qr_r` a factor step.
POLISH_KERNELS = PATH_KERNELS + ("narrow_qr_r",)
# Their CUDA function names (the warp forms), as a profiler trace shows them;
# the two narrow QR entries launch the same kernels (group or wide form).
NARROW_QR_DEVICE = "narrow_qr_(?:group|wide)_kernel"
DEVICE_NAMES = {"masked_aat_cholesky": "masked_aat_cholesky_kernel", "project_tangent": "project_tangent_kernel",
                "polyhedron_newton": "polyhedron_newton_kernel", "batched_thin_qr": NARROW_QR_DEVICE,
                "narrow_qr_r": NARROW_QR_DEVICE}
CONFIG3_KERNELS = PATH_KERNELS + ("blocked_qr_r",)
# Config 3's float32 bulk (the materialized R operator) also runs every minor
# loop as one launch of the minor-loop kernel, and so launches the
# minor-iteration kernel (its first step's device code) 0 times; configs 2
# and 4 (n = 3; the Gram operator at n = 10,240) launch neither.
DENSE_BULK_KERNELS = CONFIG3_KERNELS + ("minor_loop_r",)
MINOR_KERNELS = ("minor_direction_r", "minor_loop_r")
# Device kernels of one warm run before the panel QR kernel (H100 80GB HBM3, 700 W).
DEVICE_KERNELS_BEFORE = {"config 2": "68,888-68,892", "config 3": "17,405-17,413"}
# Device kernels of a traced warm run of config 3 before the dual-Newton kernel
# (PERF.md §5; H100 80GB HBM3, 700 W).
DEVICE_KERNELS_BEFORE_NEWTON = {"config 3": "16,878-17,010"}
# Config 2 before the dual-Newton kernel (PERF.md §5; H100 80GB HBM3, 700 W):
# host syncs of a warm eager call and device kernels of a traced warm eager
# run; a warm fused call's WHILE-node trips and device kernels (exact).
CONFIG2_BEFORE = {"host_syncs": "744-838", "device_kernels": "68,877-68,892", "while_trips": 491,
                  "fused_device_kernels": 71481}
# Device kernels of config 2's traced warm eager run before the polish's
# [JZ; D] was one launch of the stacked narrow QR (PERF.md §5; H100 80GB HBM3, 700 W).
CONFIG2_DEVICE_KERNELS_BEFORE_STACKED = 53672
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


def _panel_qr_bound(B: int, D: int, N: int, width: int = 64) -> dict:
    """The float32 panel QR's bound: S read and R written once, and of the
    R factor's 2·D·N² − ⅔·N³ operations the column steps' 2·D·nc² a panel
    of nc columns at the float32 rate of the CUDA cores, the rest (the panel
    products, 3xTF32 on the tensor cores) as three products each at the
    TF32 rate."""
    total = 2 * D * N * N - 2 * N ** 3 / 3
    steps = min(total, sum(2 * D * min(width, N - c0) ** 2 for c0 in range(0, N, width)))
    n_bytes = B * (D * N + N * N) * 4
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = B * (steps / PEAK_F32_FLOPS + 3 * (total - steps) / PEAK_TF32_FLOPS)
    ms = max(t_bytes, t_ops) * 1e3
    return {"bound_ms": ms, "bound_us": ms * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "flops": int(B * total), "bound_us_f32": _r_bound(B, D, N)["bound_us"]}


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


@contextlib.contextmanager
def _forced_plan(kern, blocks: int):
    """Run the fused kernels in one form whatever the shape: `fused_plan`
    swapped for a constant (1: the warp form, S: a cluster of S blocks) and
    restored after.  A measurement of this script, not a knob of the port."""
    saved = kern.fused_plan
    kern.fused_plan = lambda M, n, dtype: blocks
    try:
        yield
    finally:
        kern.fused_plan = saved


def _split_launches(kern) -> dict:
    """The fused kernels' launches in the split form since the last reset."""
    return {f"{name} S={S}": k for (name, S), k in kern.LAUNCHES_BY_PLAN.items() if S > 1}


# Seconds waited before each retry of a trace that saw no device kernel.
TRACE_RETRY_WAITS = (0.1, 0.3, 1.0, 2.0)
TRACE_ATTEMPTS = len(TRACE_RETRY_WAITS) + 1


def _traced_device_events(fn) -> list:
    """The device kernels of fn() traced by torch.profiler (key_averages),
    or [] where every one of TRACE_ATTEMPTS traces saw none.  On the card's
    machine a trace comes back empty now and then, sometimes several in a
    row; each retry waits longer (CUPTI is set up again for each trace)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(TRACE_ATTEMPTS):
        if attempt:
            time.sleep(TRACE_RETRY_WAITS[attempt - 1])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            if attempt:
                print(f"torch.profiler: trace {attempt + 1} saw the device kernels, the earlier ones none")
            return events
    return []


def _held_stream_us(fn, reps: int) -> float:
    """Device time a call of fn by CUDA events, the stream held by a spin
    kernel while the host queues `reps` calls: the events then time the
    device running the calls back to back, gaps between kernels included,
    and not the host queueing them.  The hold is taken longer if the host
    was still queueing when it ended."""
    for hold_ms in (50, 400):
        start, end, held = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event())
        torch.cuda._sleep(int(hold_ms * 2e6))    # cycles at 2 GHz at most: at least hold_ms
        held.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not held.query()
        _sync()
        if queued_in_time:
            return start.elapsed_time(end) * 1e3 / reps
    raise AssertionError("held-stream timing: the host was still queueing the calls when a 400 ms hold ended")


def _device_us(fn, reps: int = 50) -> float:
    """Device time a call of fn from torch.profiler: the time of every
    device kernel over `reps` warm calls, divided by `reps`.  CUDA events
    over back-to-back calls stop at the wrapper's host time (20-56 us a
    call), which would hide a kernel of a few microseconds.  Where no trace
    sees a device kernel, the time is taken by CUDA events behind a held
    stream (`_held_stream_us`), and a line says so."""
    for _ in range(3):
        fn()
    _sync()

    def calls():
        for _ in range(reps):
            fn()

    events = _traced_device_events(calls)
    if events:
        return sum(e.self_device_time_total for e in events) / reps
    us = _held_stream_us(fn, reps)
    print(f"torch.profiler saw no device kernel in {TRACE_ATTEMPTS} traces: {us:.3f} us a call by CUDA events "
          "behind a held stream (gaps between kernels included)")
    return us


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
        # kernel, those of the float32 instantiations the paths run
        # (M = 1 and M = 6; config 4's split form at M = 8; the panel QR at
        # float32; the narrow QR's group form at N = 1, 2, 3 and 6), and every
        # instantiation that spills.
        regs, on_path, entry, seconds = {}, {}, "?", {}
        for line in log.read_text().splitlines():
            if line.startswith("== ") and "compiled in" in line:
                name, _, rest = line[3:].partition(": compiled in ")
                seconds[name] = float(rest.split()[0])
            elif "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                family = next((k for k in ("minor_direction_r", "minor_loop_r", "polyhedron_newton_split", "polyhedron_newton",
                                           "masked_aat_cholesky_split", "project_tangent_split", "masked_aat_cholesky",
                                           "project_tangent", "cholesky", "cho_solve", "narrow_qr_group", "narrow_qr_wide",
                                           "blocked_qr_r")
                               if k in entry), entry)
                used = int(line.split("Used")[1].split("registers")[0])
                regs[family] = max(regs.get(family, 0), used)
                if family == "blocked_qr_r":   # config 3 runs the float32 kernel (panels of 64 columns)
                    if "kernelIfE" in entry:
                        on_path[f"{family} float32"] = used
                    continue
                # The narrow QR's group form at the paths' N (its template argument).
                dims = (8,) if family.endswith("_split") else (1, 2, 3, 6) if family == "narrow_qr_group" else (1, 6)
                for M in dims:
                    for dt, mangled in (("", "f"), (" bf16", "13__nv_bfloat16")):
                        if f"I{mangled}Li{M}E" in entry:
                            key = f"{family}{dt} M={M}"
                            on_path[key] = max(on_path.get(key, 0), used)
            elif "spill" in line and ("0 bytes spill stores" not in line or "0 bytes spill loads" not in line):
                print(f"ptxas: {entry}: {line.strip()}")
        print(f"nvcc: seconds from the start of the build to each source's object: {seconds}")
        print(f"ptxas: most registers per thread by kernel: {regs}")
        print(f"ptxas: registers per thread of the float32 and bf16 instantiations on the paths: {on_path}")
    return dt


def phase_kernels(kern) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel records."""
    dev = torch.device("cuda:0")
    t_phase = time.perf_counter()
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

    _check_narrow_qr(kern, rng, worst)

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
    _check_split(kern, rng)
    _sync()
    rec["polyhedron_newton"]["plans_checked"] = _check_newton(kern, rng, worst)
    _sync()
    minor_calls = _check_minor(kern, rng, worst)
    _sync()
    loop_calls = _check_minor_loop(kern, worst)
    _sync()
    print(f"fused kernels by plan (kernel, blocks per instance) over phase 3's checks: {dict(kern.LAUNCHES_BY_PLAN)}")
    _check_blocked_qr(kern, rng, worst)
    _sync()
    for name in rec:
        print(f"{name}: max abs err {rec[name]['max_abs_err']:.3e} over every checked shape")
    _time_kernels(kern, rng, rec)
    _time_minor(kern, rng, rec, minor_calls)
    _time_minor_loop(kern, rec, loop_calls)
    print(f"phase 3 (kernels): {time.perf_counter() - t_phase:.1f} s")
    return rec


# The narrow QR's checked shapes: every path's, the kernel tests' and the
# gate's two corners (4 and 64 instances of 2048 x 16: the wide form).
NARROW_QR_CHECKS = ((1024, 35, 3), (1024, 3, 1), (16384, 35, 3), (16384, 3, 1), (64, 192, 6), (200, 32, 3), (140, 16, 8),
                    (1024, 3, 2), (1024, 7, 3), (512, 3, 1), (1, 3, 1), (1, 3, 2), (1, 7, 3), (1, 35, 3), (1, 192, 6),
                    (130, 300, 16), (4, 2048, 16), (64, 2048, 16))


def _stack(JZ: torch.Tensor, dbot: torch.Tensor) -> torch.Tensor:
    """The polish's stacked matrix [JZ; diag(dbot)]."""
    return torch.cat([JZ, torch.diag_embed(dbot)], dim=-2)


def _polish_dbot(rng, B: int, N: int, dev, dtype=torch.float32) -> torch.Tensor:
    """dbot as the polish builds it: 1 on a fixed coordinate, sqrt(reg) on
    a free one (reg = 1e-3), a third of the coordinates fixed; the first
    lane has none fixed, the second all."""
    fixed = rng.random((B, N)) < 1 / 3
    fixed[0], fixed[min(1, B - 1)] = False, True
    return torch.as_tensor(np.where(fixed, 1.0, math.sqrt(1e-3)), dtype=torch.float32, device=dev).to(dtype)


def _check_narrow_qr(kern, rng, worst) -> None:
    """The narrow QR kernel (`batched_thin_qr`, Q and R; `narrow_qr_r`, R
    only, of S or of the stacked [JZ; diag(dbot)]) against its plain version
    at every shape of NARROW_QR_CHECKS in float32 (Q within KERNEL_ATOL, R
    within KERNEL_ATOL·√D: the sums run in another order), R upper
    triangular with a positive diagonal, QR = A; the R-only and stacked
    forms bitwise equal to the full R of the same (stacked) matrix; a lane
    alone and a permuted batch bitwise equal to the batch's lanes; NaN in one
    instance only; a zero column floored at √tiny; refused operands."""
    dev = torch.device("cuda:0")
    f32 = torch.float32
    forms = collections.Counter()
    for B, D, N in NARROW_QR_CHECKS:
        A = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=f32, device=dev)
        tag = f"{B}x{D}x{N} (plan {kern.narrow_qr_plan(D, N, f32)})"
        forms["wide" if kern.narrow_qr_plan(D, N, f32) == 0 else "group"] += 1
        Q, R = kern.batched_thin_qr(A)
        Qp, Rp = kern.batched_thin_qr_plain(A)
        worst("batched_thin_qr", max(
            _check_close(f"qr Q {tag}", Q, Qp),
            _check_close(f"qr R {tag}", R, Rp, atol=KERNEL_ATOL * math.sqrt(D)),
        ))
        if not (torch.diagonal(R, dim1=1, dim2=2) > 0).all() or torch.tril(R, -1).abs().max() != 0:
            raise AssertionError(f"qr {tag}: R must be upper triangular with a positive diagonal")
        if not torch.allclose(Q @ R, A, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"qr {tag}: Q R does not reproduce A")
        _require(torch.equal(_bits(kern.narrow_qr_r(A)), _bits(R)), f"narrow_qr_r {tag}: R only differs from the full R")
        # The stacked form at the same total rows: JZ of D - N rows and dbot.
        if D > N:
            JZ, dbot = A[:, : D - N].contiguous(), _polish_dbot(rng, B, N, dev)
            S = _stack(JZ, dbot)
            Rs = kern.narrow_qr_r(JZ, dbot)
            worst("narrow_qr_r", _check_close(f"narrow_qr_r stacked {tag}", Rs, kern.narrow_qr_r_plain(JZ, dbot),
                                              atol=KERNEL_ATOL * math.sqrt(D)))
            _require(torch.equal(_bits(Rs), _bits(kern.narrow_qr_r(S))) and torch.equal(_bits(Rs), _bits(kern.batched_thin_qr(S)[1])),
                     f"narrow_qr_r stacked {tag}: not bitwise the R of the stacked matrix")
        # A lane's bits do not depend on its batch: lanes alone, a permuted batch.
        if B > 1 and (D, N) in ((35, 3), (3, 1), (7, 3), (192, 6), (2048, 16)):
            perm = torch.as_tensor(rng.permutation(B), device=dev)
            Qq, Rq = kern.batched_thin_qr(A[perm].contiguous())
            _require(torch.equal(_bits(Qq), _bits(Q[perm])) and torch.equal(_bits(Rq), _bits(R[perm])),
                     f"qr {tag}: a permuted batch differs from the batch's lanes")
            for b in (0, B // 2, B - 1):
                Qb, Rb = kern.batched_thin_qr(A[b:b + 1].contiguous())
                _require(torch.equal(_bits(Qb), _bits(Q[b:b + 1])) and torch.equal(_bits(Rb), _bits(R[b:b + 1])),
                         f"qr {tag}: lane {b} alone differs from lane {b} in the batch")
                if D > N:
                    _require(torch.equal(_bits(kern.narrow_qr_r(JZ[b:b + 1], dbot[b:b + 1])), _bits(Rs[b:b + 1])),
                             f"narrow_qr_r stacked {tag}: lane {b} alone differs from lane {b} in the batch")
    print(f"narrow QR: {sum(forms.values())} shapes checked ({dict(forms)} by form); R only and stacked bitwise equal "
          "to the full R; lanes alone and permuted batches bitwise equal to the batch's")
    # NaN in one instance stays there; a zero column floors at sqrt(tiny); in
    # both forms, the other lanes' bits unchanged.
    sqrt_tiny = torch.sqrt(torch.tensor(torch.finfo(f32).tiny, device=dev))
    for B, D, N in ((1024, 35, 3), (64, 192, 6), (4, 2048, 16)):
        A = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=f32, device=dev)
        Q0, R0 = kern.batched_thin_qr(A)
        A[1, D // 2, N - 1] = float("nan")
        A[2, :, 1] = 0.0
        Q, R = kern.batched_thin_qr(A)
        Qp, Rp = kern.batched_thin_qr_plain(A)
        rest = torch.ones(B, dtype=torch.bool, device=dev)
        rest[1:3] = False
        tag = f"qr {B}x{D}x{N}"
        _require(torch.equal(torch.isnan(R), torch.isnan(Rp)) and torch.equal(torch.isnan(Q), torch.isnan(Qp)),
                 f"{tag}: NaN pattern differs from the plain version's")
        _require(bool(torch.isnan(R[1]).any()) and bool(torch.isfinite(R[rest]).all()) and bool(torch.isfinite(R[2]).all()),
                 f"{tag}: NaN must stay in its own instance")
        _require(torch.equal(_bits(R[rest]), _bits(R0[rest])) and torch.equal(_bits(Q[rest]), _bits(Q0[rest])),
                 f"{tag}: a NaN or a zero column in one instance moved another's bits")
        _require(bool(R[2, 1, 1] == sqrt_tiny) and bool(Rp[2, 1, 1] == sqrt_tiny) and bool((Q[2, :, 1] == 0).all()),
                 f"{tag}: a zero column must floor its norm at sqrt(tiny) = {float(sqrt_tiny):.3e}, got {float(R[2, 1, 1]):.3e}")
        _require(torch.equal(_bits(kern.narrow_qr_r(A)), _bits(R)), f"narrow_qr_r {B}x{D}x{N}: R only differs with a NaN lane")
    print("narrow QR: NaN stays in its instance, a zero column floors at sqrt(tiny), the other lanes' bits unchanged "
          "(group and wide forms)")
    # Empty batches launch nothing; refused operands raise before any launch.
    before = dict(kern.LAUNCHES)
    z = lambda *shape, **kw: torch.zeros(shape, device=dev, **kw)
    _require(kern.narrow_qr_r(z(0, 32, 3), z(0, 3)).shape == (0, 3, 3) and kern.narrow_qr_r(z(0, 35, 3)).shape == (0, 3, 3),
             "narrow_qr_r: an empty batch must give (0, N, N)")
    for i, (exc, call) in enumerate((
        (ValueError, lambda: kern.narrow_qr_r(z(4, 40, 17))),                     # N > 16
        (ValueError, lambda: kern.narrow_qr_r(z(4, 2040, 16), z(4, 16))),         # D + N > 2048
        (ValueError, lambda: kern.narrow_qr_r(z(4, 32, 3), z(4, 3, dtype=torch.float64))),
        (ValueError, lambda: kern.narrow_qr_r(z(4, 32, 3), z(4, 3).cpu())),
        (ValueError, lambda: kern.narrow_qr_r(z(4, 3, 32).mT)),                    # not contiguous
        (ValueError, lambda: kern.narrow_qr_r(z(4, 32, 3), z(4, 2))),
        (ValueError, lambda: kern.batched_thin_qr(z(4, 2, 3))),                   # D < N
        (ValueError, lambda: kern.batched_thin_qr(z(4, 2048, 16, dtype=torch.float64))),  # the wide form's shared memory
    )):
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"narrow QR: refused operand {i} was accepted")
    _require(kern.LAUNCHES == before, "narrow QR: an empty batch or a refused operand launched")


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
    # The split form (a cluster per instance): config 4's width with a shared
    # A, ragged n, the JAX package's sharded-Gram n and m = 16.
    cases += [(4, 8, 10240, True), (3, 8, 10277, False), (3, 8, 40960, False), (3, 16, 10240, False)]
    # One instance, as a single solve launches them: a regular lane (B = 1)
    # and the degenerate pair alone (B = 2), config 4's among them.
    single = [(1, 2, 5), (1, 1, 3), (1, 3, 4), (1, 1, 2), (1, 6, 192), (1, 8, 10240), (2, 2, 5), (2, 8, 10240)]
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


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of t (NaN included), for bitwise comparisons."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _check_split(kern, rng) -> None:
    """The split form beyond `_check_fused`'s cases: float64 and bf16 at
    config 4's (1, 8, 10240) against their plain versions, batch
    independence (each lane of a (130, 8, 10240) call bitwise equal to the
    same lane run alone at B = 1), determinism (two calls bitwise equal), and
    the split launches of every large-n case."""
    dev = torch.device("cuda:0")
    before = dict(kern.LAUNCHES_BY_PLAN)
    m, n = 8, 10240
    S = kern.fused_plan(m, n, torch.float32)
    if S < 2:
        raise AssertionError(f"fused_plan({m}, {n}) = {S}: config 4's width must take the split form")
    A, fixed, r = (t[:1].contiguous() for t in _fused_case(rng, 3, m, n, False, dev))
    row = float(torch.linalg.vector_norm(A, dim=-1).max())
    # float64: the same source, sums in another order than the plain
    # version's matmul: rtol 1e-12, atol 1e-12·√n·(row norm or max|r|).
    A64, r64 = A.double(), r.double()
    for reg in (0.0, 1e-3):
        L64, Lp = kern.masked_aat_cholesky(A64, fixed, reg), kern.masked_aat_cholesky_plain(A64, fixed, reg)
        err = float((L64 - Lp).abs().max())
        if not torch.allclose(L64, Lp, rtol=1e-12, atol=1e-12 * math.sqrt(n) * row):
            raise AssertionError(f"masked_aat_cholesky float64 1x{m}x{n} reg={reg}: off its plain version by {err:.3e}")
    for unmasked in (False, True):
        P, Pp = (f(A64, L64, fixed, r64, unmasked_output=unmasked) for f in (kern.project_tangent, kern.project_tangent_plain))
        err64 = float((P - Pp).abs().max())
        if not torch.allclose(P, Pp, rtol=1e-12, atol=1e-12 * math.sqrt(n) * float(r64.abs().max())):
            raise AssertionError(f"project_tangent float64 1x{m}x{n} unmasked={unmasked}: off its plain version by {err64:.3e}")
    print(f"split form float64 1x{m}x{n}: factor off its plain version by {err:.3e}, projection by {err64:.3e}")
    # bf16: within one bf16 ulp of the bf16 plain version plus the float32
    # kernel's slack, as in phase 9.
    Ab, rb = A.to(BF16), r.to(BF16)
    atol = KERNEL_ATOL * math.sqrt(n) * row
    for reg in (0.0, 1e-3):
        Lb = kern.masked_aat_cholesky(Ab, fixed, reg)
        got = _check_bf16(f"masked_aat_cholesky bf16 1x{m}x{n} reg={reg}", Lb, kern.masked_aat_cholesky_plain(Ab, fixed, reg), atol)
        print(f"split form bf16 masked_aat_cholesky 1x{m}x{n} reg={reg}: max err {got[0]:.3e} ({got[1]:.3f} ulp), bitwise {got[2]}")
    atol = KERNEL_ATOL * math.sqrt(n) * float(r.abs().max())
    for unmasked in (False, True):
        got = _check_bf16(f"project_tangent bf16 1x{m}x{n} unmasked={unmasked}",
                          kern.project_tangent(Ab, Lb, fixed, rb, unmasked_output=unmasked),
                          kern.project_tangent_plain(Ab, Lb, fixed, rb, unmasked_output=unmasked), atol)
        print(f"split form bf16 project_tangent 1x{m}x{n} unmasked={unmasked}: max err {got[0]:.3e} ({got[1]:.3f} ulp), bitwise {got[2]}")

    # Batch independence and determinism, degenerate lanes (NaN) included.
    B = 130
    A, fixed, r = _fused_case(rng, B, m, n, False, dev)
    L, L2 = kern.masked_aat_cholesky(A, fixed), kern.masked_aat_cholesky(A, fixed)
    Lr = kern.masked_aat_cholesky(A, fixed, 1e-3)
    P, P2 = kern.project_tangent(A, Lr, fixed, r), kern.project_tangent(A, Lr, fixed, r)
    if not (torch.equal(_bits(L), _bits(L2)) and torch.equal(_bits(P), _bits(P2))):
        raise AssertionError(f"split form {B}x{m}x{n}: two calls on the same inputs differ")
    for b in (0, 1, 64, B - 3, B - 2, B - 1):
        one = lambda t: t[b:b + 1].contiguous()
        Lb1 = kern.masked_aat_cholesky(one(A), one(fixed))
        Pb1 = kern.project_tangent(one(A), one(Lr), one(fixed), one(r))
        if not (torch.equal(_bits(Lb1), _bits(L[b:b + 1])) and torch.equal(_bits(Pb1), _bits(P[b:b + 1]))):
            raise AssertionError(f"split form {B}x{m}x{n}: lane {b} alone differs from lane {b} in the batch")
    print(f"split form {B}x{m}x{n}: deterministic, and lanes 0, 1, 64, {B - 3}, {B - 2}, {B - 1} alone bitwise equal to the batch's")
    split = {k: v - before.get(k, 0) for k, v in kern.LAUNCHES_BY_PLAN.items() if k[1] > 1 and v > before.get(k, 0)}
    if not {"masked_aat_cholesky", "project_tangent"} <= {name for name, _ in split}:
        raise AssertionError(f"split form: the checks above did not launch both kernels split: {split}")


# ---------------------------------------------------------------------------
# Phase 3: the dual-Newton kernel of ops/polyproject
# ---------------------------------------------------------------------------

# The kernel against its plain version (the masked loop of ops/polyproject on
# the same card, the old solve kernel inside): the two sum in other orders,
# so a lane may take another trip count; v within NEWTON_VTOL·(1 + ‖x‖∞) on
# every lane where both converge (a bf16 v also within one bf16 ulp of the
# plain one's: each rounds its float32 v once), ‖F‖ ≤ tol on every lane
# the plain loop converges on, in both dtypes, no NaN where the plain version
# has none, and at least one lane held in each case.
NEWTON_VTOL = 1e-4
# The paths' shapes (B, m, n, A shared by the batch): configs 2 and 5 and
# sphere-b1024 (the bulk chunk), config 3, a float32 solve at B = 1, config 4.
NEWTON_SHAPES = ((512, 1, 3, False), (64, 6, 192, True), (1, 1, 3, False), (1, 8, 10240, False))
# The split form's other cluster sizes on a path: config 4's explicit-collective
# run (n = 2048, S = 8) and its card-against-CPU run (n = 1024, S = 4).
NEWTON_SPLIT_SHAPES = ((1, 8, 1024, False), (1, 8, 2048, False))
# Shapes the paths called the kernel at, recorded from phases 4-11 (`_record_newton_shapes`).
NEWTON_SEEN: dict = {}


def _newton_case(rng, B, m, n, shared, dev, dtype=torch.float32):
    """Polyhedra and points like the paths': A (a stride-0 expand of one
    matrix when shared), boxes around 0, b = A·p for a point p in the box,
    x spread over a few units; with B ≥ 3 the last lane is degenerate: x
    above every upper bound, so no column is inside its box at λ = 0 and the
    first Newton matrix is reg·I."""
    A = rng.standard_normal((1 if shared else B, m, n))
    l = -np.abs(rng.standard_normal((B, n))) - 0.1
    u = np.abs(rng.standard_normal((B, n))) + 0.1
    b = np.einsum("bmn,bn->bm", np.broadcast_to(A, (B, m, n)), rng.uniform(l, u))
    x = 2.0 * rng.standard_normal((B, n))
    if B >= 3:
        x[-1] = u[-1] + 1.0 + rng.random(n)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)
    return (T(A).expand(B, m, n) if shared else T(A)), T(b), T(l), T(u), T(x)


def _newton(fn, A, b, l, u, x, lam0=None, active=None):
    """fn (the kernel wrapper or its plain version) with the projection's
    defaults for x's dtype: tol eps^0.75, reg eps^0.5, 100 trips at most,
    the line-search geometry of `line_search_geometry`."""
    from benlsip_tpu_torch.ops.polyproject import line_search_geometry

    eps = torch.finfo(x.dtype).eps
    return fn(A, b, l, u, x, eps ** 0.75, eps ** 0.5, 100, *line_search_geometry(x.dtype), lam0=lam0, active=active)


@contextlib.contextmanager
def _forced_newton_plan(kern, plan: int):
    """Run the dual-Newton kernel in one layout whatever the shape:
    `newton_plan` swapped for a constant and restored after.  A measurement
    of this script, not a knob of the port."""
    saved = kern.newton_plan
    kern.newton_plan = lambda M, n, dtype: plan
    try:
        yield
    finally:
        kern.newton_plan = saved


@contextlib.contextmanager
def _plain_restarts(out: list):
    """Append to `out` how many lanes of each warm-started plain dual-Newton
    loop run in the block spent their cold restart (read off the loop's
    last carry)."""
    from benlsip_tpu_torch.ops import polyproject

    saved = polyproject.masked_while

    def spy(cond, body, carry, run, cap):
        c = saved(cond, body, carry, run, cap)
        out.append(int(c.restarted.sum()))   # a warm start begins with no lane restarted
        return c

    polyproject.masked_while = spy
    try:
        yield
    finally:
        polyproject.masked_while = saved


def _newton_gate(tag: str, got, want, A, b, x, lam0=None, active=None) -> float:
    """Hold the kernel's (v, λ, trips) to the plain version's (module
    comment above NEWTON_VTOL); returns the largest |v − v_plain| over the
    lanes held."""
    v, lam, it = got
    vp, lamp, itp = want
    B = x.shape[0]
    eps = torch.finfo(x.dtype).eps
    A64, b64 = A.double(), b.double()
    tol_val = eps ** 0.75 * (1 + torch.linalg.vector_norm(b64, dim=-1))
    fres = lambda vv: torch.linalg.vector_norm((A64 @ vv.double().unsqueeze(-1)).squeeze(-1) - b64, dim=-1)
    run = torch.ones(B, dtype=torch.bool, device=x.device) if active is None else active
    conv_k, conv_p = (fres(v) <= tol_val) & run, (fres(vp) <= tol_val) & run
    scale = 1 + x.double().abs().amax(-1)
    dv = (v.double() - vp.double()).abs()
    slack = NEWTON_VTOL * scale
    if x.dtype == torch.bfloat16:
        dv = (dv - _bf16_ulp(vp.double()).double()).clamp_min(0)
    dv = dv.amax(-1)
    both = conv_k & conv_p
    nan_k = torch.isnan(v).any(-1) | torch.isnan(lam).any(-1)
    nan_p = torch.isnan(vp).any(-1) | torch.isnan(lamp).any(-1)
    hist = collections.Counter((it - itp)[run].tolist())
    print(f"polyhedron_newton {tag}: lanes {B} ({int(run.sum())} active), converged kernel {int(conv_k.sum())} plain "
          f"{int(conv_p.sum())}, max |dv|/(1+|x|) where both converge {float((dv / scale)[both].max()) if both.any() else 0.0:.3e}, "
          f"trips kernel {int(it[run].sum())} plain {int(itp[run].sum())}, trip differences (kernel - plain: lanes) "
          f"{dict(sorted(hist.items()))}")
    _require(not bool((nan_k & ~nan_p).any()), f"polyhedron_newton {tag}: NaN where the plain version has none")
    _require(bool((dv <= slack)[both].all()), f"polyhedron_newton {tag}: v off the plain version's by "
             f"{float((dv / scale)[both].max()):.3e}·(1 + |x|) where both converge")
    _require(bool(both.any()), f"polyhedron_newton {tag}: no lane converged in both, so none was compared")
    _require(bool(conv_k[conv_p].all()), f"polyhedron_newton {tag}: {int((conv_p & ~conv_k).sum())} lanes the plain "
             "loop converges on miss ‖F‖ ≤ tol")
    if active is not None:
        idle = ~active
        start = torch.zeros_like(lam) if lam0 is None else lam0
        _require(bool((it[idle] == 0).all()) and torch.equal(_bits(lam[idle]), _bits(start[idle])),
                 f"polyhedron_newton {tag}: an inactive lane ran or moved its dual")
        _require(bool((dv[idle] <= slack[idle]).all()), f"polyhedron_newton {tag}: an inactive lane's v is off")
    return float((v.double() - vp.double()).abs().amax(-1)[both | ~run].max()) if B else 0.0


def _check_newton(kern, rng, worst) -> list:
    """`polyhedron_newton` against its plain version at the paths' shapes
    (NEWTON_SHAPES, NEWTON_SPLIT_SHAPES), cold, warm from the plain dual plus noise, warm from a
    stale dual (λ* + 1e3·noise at config 3's shape: the plain loop spends
    its cold restart on several lanes) and with a third of the lanes
    inactive; in bf16 at the bf16 paths' shapes; batch independence (a lane
    alone equals its bits in the batch, one per layout) and determinism
    (two calls bitwise equal), in both dtypes.  Returns the layouts (plans)
    checked."""
    from benlsip_tpu_torch.ops.polyproject import newton_plain

    dev = torch.device("cuda:0")
    cases = [(s, torch.float32) for s in NEWTON_SHAPES + NEWTON_SPLIT_SHAPES]
    cases += [((512, 1, 3, False), torch.bfloat16), ((64, 6, 192, True), torch.bfloat16)]
    for (B, m, n, shared), dtype in cases:
        A, b, l, u, x = _newton_case(rng, B, m, n, shared, dev, dtype)
        tag = f"{B}x{m}x{n}{' shared A' if shared else ''} {str(dtype).removeprefix('torch.')} plan {kern.newton_plan(m, n, dtype)}"
        cold = _newton(kern.polyhedron_newton, A, b, l, u, x)
        cold_p = _newton(newton_plain, A, b, l, u, x)
        worst("polyhedron_newton", _newton_gate(tag + " cold", cold, cold_p, A, b, x))
        lam0 = (cold_p[1].float() + torch.as_tensor(rng.standard_normal((B, m)), dtype=torch.float32, device=dev)).to(dtype)
        worst("polyhedron_newton", _newton_gate(tag + " warm", _newton(kern.polyhedron_newton, A, b, l, u, x, lam0),
                                                _newton(newton_plain, A, b, l, u, x, lam0), A, b, x, lam0))
        active = torch.as_tensor(np.arange(B) % 3 != 1, device=dev)
        worst("polyhedron_newton", _newton_gate(
            tag + " warm, lanes 1 mod 3 inactive", _newton(kern.polyhedron_newton, A, b, l, u, x, lam0, active),
            _newton(newton_plain, A, b, l, u, x, lam0, active), A, b, x, lam0, active))
        if (m, n) == (6, 192) and dtype == torch.float32:
            stale = (cold_p[1] + 1e3 * torch.as_tensor(rng.standard_normal((B, m)), dtype=dtype, device=dev)).contiguous()
            restarts = []
            with _plain_restarts(restarts):
                want = _newton(newton_plain, A, b, l, u, x, stale)
            _require(restarts[-1] > 0, f"polyhedron_newton {tag}: the stale warm start restarted no plain lane")
            worst("polyhedron_newton", _newton_gate(f"{tag} stale warm start ({restarts[-1]} plain lanes restarted)",
                                                    _newton(kern.polyhedron_newton, A, b, l, u, x, stale), want, A, b, x, stale))
        if B > 1:
            again = _newton(kern.polyhedron_newton, A, b, l, u, x)
            alone = [_newton(kern.polyhedron_newton, A[k:k + 1], b[k:k + 1], l[k:k + 1], u[k:k + 1], x[k:k + 1])
                     for k in (0, B // 2, B - 1)]
            _require(all(torch.equal(_bits(g), _bits(w)) for g, w in zip(again, cold)),
                     f"polyhedron_newton {tag}: two calls differ")
            for k, one in zip((0, B // 2, B - 1), alone):
                _require(all(torch.equal(_bits(g), _bits(w[k:k + 1])) for g, w in zip(one, cold)),
                         f"polyhedron_newton {tag}: lane {k} alone differs from its bits in the batch")
    checked = {plan: k for (name, plan), k in kern.LAUNCHES_BY_PLAN.items() if name == "polyhedron_newton"}
    print(f"polyhedron_newton: launches by plan over the checks {checked}")
    # Refused operands raise before any launch.
    A, b, l, u, x = _newton_case(rng, 8, 2, 5, False, dev)
    before = dict(kern.LAUNCHES)
    for exc, call in (
        (TypeError, lambda: _newton(kern.polyhedron_newton, A.double(), b.double(), l.double(), u.double(), x.double())),
        (ValueError, lambda: _newton(kern.polyhedron_newton, torch.zeros((8, 17, 5), device=dev), torch.zeros((8, 17), device=dev), l, u, x)),
        (ValueError, lambda: _newton(kern.polyhedron_newton, A, b, l.cpu(), u, x)),
        (ValueError, lambda: _newton(kern.polyhedron_newton, A, b, l, u, x.T.contiguous().T)),
    ):
        try:
            call()
        except exc:
            continue
        raise AssertionError("polyhedron_newton: a refused operand did not raise")
    _require(kern.LAUNCHES == before, "polyhedron_newton: a refused operand launched")
    return sorted(checked)


def _newton_bound(B: int, m: int, n: int, shared: bool, trips: int, dtype: torch.dtype, warm: bool) -> dict:
    """The least time of one call: inputs read once (A once if shared, b,
    l, u, x, λ₀) and v, λ, trips written once, over the memory rate; or the
    operations this run's trips need (each trip: z, K = A D Aᵀ over every
    column, F and q; the m×m Cholesky and solve; w; ~5 flops a column at each
    of the line search's 1 + grow_pows + 17·n_section points; F and q at the
    trial point; plus F(0), F(λ₀) and the final v a lane) over the float32 peak."""
    from benlsip_tpu_torch.ops.polyproject import line_search_geometry

    G, n_sec = line_search_geometry(dtype)
    item = torch.finfo(dtype).bits // 8
    n_bytes = ((1 if shared else B) * m * n + B * (m + 3 * n) + (B * m if warm else 0) + B * (n + m)) * item + 4 * B
    per_trip = n * (2 * m + m * (m + 1) + 2 * m + 3 + 2 * m + 5 * (1 + G + 17 * n_sec) + 4 * m + 3) + m ** 3 / 3 + 2 * m * m
    return _bound(n_bytes, trips * per_trip + 6 * B * m * n)


def _time_newton(kern, rng, rec) -> None:
    """The dual-Newton kernel at the paths' shapes in turns with its plain
    version on the card (the old call site: the masked loop with the old
    solve kernel, one host sync a trip): kernel, plain, plain, kernel (CUDA
    events; fewer calls of the plain loop), each kernel's device µs a call
    from torch.profiler, the bound from this run's trips; bf16 beside
    float32.  Then the layouts: the grid on the lanes against the columns on
    the lanes at n from 3 to 32, and the split form against one warp at
    config 4's shape, by device µs."""
    from benlsip_tpu_torch.ops.polyproject import newton_plain

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    cases = [(s, torch.float32) for s in NEWTON_SHAPES] + [((512, 1, 3, False), torch.bfloat16), ((64, 6, 192, True), torch.bfloat16)]
    for (B, m, n, shared), dtype in cases:
        A, b, l, u, x = _newton_case(rng, B, m, n, shared, dev, dtype)
        x[-1] = x[0]    # no degenerate lane in a timed batch
        kernel = lambda: _newton(kern.polyhedron_newton, A, b, l, u, x)
        plain = lambda: _newton(newton_plain, A, b, l, u, x)
        trips = int(kernel()[2].sum())
        reps = {"kernel": 200 if n < 10240 else 50, "plain": 10 if n < 10240 else 3}
        turns = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel"):
            turns[name].append(_cuda_ms(kernel if name == "kernel" else plain, reps[name], 2))
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        dev_us = _device_us(kernel, 20)
        bound = _newton_bound(B, m, n, shared, trips, dtype, False)
        dt = "" if dtype == torch.float32 else "_bf16"
        key = f"_{B}x{m}x{n}{dt}"
        rec["polyhedron_newton"].update({
            f"ms{key}": ms["kernel"], f"plain_ms{key}": ms["plain"],
            # The float32 plain version is the old call site (the loop with the old solve kernel).
            **({f"old_site_ms{key}": ms["plain"]} if dtype == torch.float32 else {}),
            f"device_us{key}": dev_us, f"bound_ms{key}": bound["bound_ms"], f"bound_us{key}": bound["bound_us"],
            f"bound_by{key}": bound["bound_by"], f"trips{key}": trips, f"plan{key}": kern.newton_plan(m, n, dtype),
        })
        if (B, m, n, dtype) == (512, 1, 3, torch.float32):
            rec["polyhedron_newton"].update({"ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound["bound_ms"],
                                             "bound_by": bound["bound_by"], "library_ms": None, "shape": "512x1x3"})
        plain_name = "plain loop (old site)" if dtype == torch.float32 else "plain version (the float32 loop, rounded)"
        print(f"polyhedron_newton {B}x{m}x{n}{' shared A' if shared else ''} {str(dtype).removeprefix('torch.')} "
              f"(plan {kern.newton_plan(m, n, dtype)}, {trips} trips over the batch): kernel {ms['kernel']:.4f} ms "
              f"(device {dev_us:.2f} us a call), {plain_name} {ms['plain']:.4f} ms "
              f"(turns: kernel {['%.4f' % t for t in turns['kernel']]}, plain {['%.4f' % t for t in turns['plain']]}); "
              f"bound {bound['bound_us']:.4f} us ({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")
    layouts = {}
    for n in (3, 8, 16, 32):
        A, b, l, u, x = _newton_case(rng, 512, 1, n, False, dev)
        x[-1] = x[0]
        for plan in (0, 1):
            with _forced_newton_plan(kern, plan):
                layouts[f"n={n} plan {plan}"] = _device_us(lambda: _newton(kern.polyhedron_newton, A, b, l, u, x), 20)
    A, b, l, u, x = _newton_case(rng, 1, 8, 10240, False, dev)
    plan = kern.newton_plan(8, 10240, torch.float32)
    for p_ in (plan, 1):
        with _forced_newton_plan(kern, p_):
            layouts[f"1x8x10240 plan {p_}"] = _device_us(lambda: _newton(kern.polyhedron_newton, A, b, l, u, x), 3)
    rec["polyhedron_newton"].update({f"device_us_layout_{k.replace(' ', '_')}": v for k, v in layouts.items()})
    print("polyhedron_newton layouts, device us a call (512 x 1 x n: plan 0 the grid on the lanes, plan 1 the columns "
          "on the lanes; 1 x 8 x 10240: the split form against one warp): "
          + ", ".join(f"{k} {v:.2f}" for k, v in layouts.items()))
    print(f"polyhedron_newton timings: {time.perf_counter() - t0:.1f} s")


def _record_newton_shapes(kern) -> None:
    """From here on, record in NEWTON_SEEN each (B, m, n, dtype, plan) the
    paths call the dual-Newton kernel at (the wrapper wrapped; it launches
    as before)."""
    call = kern.polyhedron_newton

    @functools.wraps(call)   # `__wrapped__`: the wrapper itself, for calls that are not the paths'
    def recording(A, b, l, u, x, *args, **kwargs):
        key = (A.shape[0], A.shape[1], A.shape[2], str(x.dtype).removeprefix("torch."),
               kern.newton_plan(A.shape[1], A.shape[2], x.dtype))
        NEWTON_SEEN[key] = NEWTON_SEEN.get(key, 0) + 1
        return call(A, b, l, u, x, *args, **kwargs)

    kern.polyhedron_newton = recording



# ---------------------------------------------------------------------------
# Phase 3c: the minor-iteration kernel (`minor_direction_r`), then the
# minor-loop kernel (`minor_loop_r`)
# ---------------------------------------------------------------------------

# Kernel against its plain version (the composition of solver/cg on the
# card): the same CG status on every lane, and w of each lane whose trip
# count agrees within MINOR_W_RTOL·(‖w‖∞ of the plain lane) + MINOR_W_ATOL.
# Both run the same float32 CG, but the kernel sums R p, Rᵀu and the dot
# products in another order (fmaf and a fixed tree against torch's bmm and
# sum): ~n·eps = 2.3e-5 relative a product at n = 192, which the CG's
# conditioning (κ(H) ≤ 1e2 on the synthetic inputs, ~6 on config 3's J) can
# amplify to ~2e-3 over its trips.  A lane whose summed residual lands on the
# other side of its stopping test runs one trip more or less: at the solver's
# kappa2 (0.1) at most MINOR_TRIP_FLIPS lanes a check may, at kappa2 = 1e-3
# (‖v‖² < 1e-6 ‖v₀‖², near the float32 floor of the residual at κ(H) = 1e2)
# at most a fifth of the lanes (MINOR_FLIP_SHARE; up to 8 of 64 seen at
# 64×96×96 on the H100), each printed.  Such a lane's w is held to the
# plain version run in float64 on the same inputs, as below: one trip of a
# CG at kappa2 = 1e-3 moves w by ~κ·kappa2·‖v₀‖ (up to 6e-4 of ‖w‖∞ in a
# CPU run with R perturbed by 2e-7), within MINOR_W_RTOL.  On config 3's
# real inputs near criticality g is large (‖g‖ ≈ 2) and its projection small
# (‖w‖ ≈ 1e-3), so every float32 evaluation of the reference algorithm — the
# plain version's too — is off the float64 answer by up to ~n·eps·‖g‖
# amplified by the CG (5e-4 against ‖w‖∞ 1.4e-3 on one lane on the H100):
# there, and on every lane with other trips, a lane passes where the kernel
# is no farther from the plain version run in float64 than MINOR_F64_FACTOR
# times the plain float32 version is, plus MINOR_W_RTOL of the lane's ‖w‖∞.
MINOR_W_RTOL = 2e-3
MINOR_W_ATOL = 1e-6
MINOR_TRIP_FLIPS = 2
MINOR_FLIP_SHARE = 0.2
MINOR_F64_FACTOR = 2.0
# (B, k, m, n): config 3's shape, one lane alone, a half-size square R, and
# the gate's corners: the largest square R at m = 6 and at m = 16, one row of
# R at the most columns (256), and an R of an odd number of floats (the
# synchronous copy into shared memory).
MINOR_CHECKS = ((64, 192, 6, 192), (1, 192, 6, 192), (64, 96, 3, 96), (8, 235, 6, 235), (8, 230, 16, 230),
                (8, 1, 1, 256), (8, 231, 1, 231))
# Calls of the kernel recorded from config 3 (the real inputs): up to
# MINOR_RECORDED of the pipeline's float32 bulk and the last
# MINOR_RECORDED // 2 of a float32 solve to convergence.
MINOR_RECORDED = 60


def _minor_case(rng, B, k, m, n, dev):
    """The kernel's arguments for one minor iteration: one A of N(0, 1/n)
    shared by the batch (stride 0), shared bounds ±0.8, x inside them, s a
    small step, g of N(0, 1), 15% of the columns fixed, and per lane an R of
    k rows whose singular values spread over one decade (κ(H) = 1e2): lane 3
    R = 0 (zero curvature at the first trip), every fourth lane a trust
    radius of 0.02 (bound hits), every seventh not active, and g a fiftieth
    as long on every other lane (interior solves)."""
    f32 = torch.float32
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f32, device=dev)
    A = t(rng.standard_normal((1, m, n)) / math.sqrt(n)).expand(B, m, n)
    xl, xu = t(np.full((1, n), -0.8)).expand(B, n), t(np.full((1, n), 0.8)).expand(B, n)
    x = t(rng.uniform(-0.6, 0.6, (B, n)))
    s = t(0.01 * rng.standard_normal((B, n)))
    g = t(rng.standard_normal((B, n)) * np.where(np.arange(B) % 2 == 0, 0.02, 1.0)[:, None])
    fixed = torch.as_tensor(rng.random((B, n)) < 0.15, device=dev)
    from benlsip_tpu_torch.ops.cholesky import factor_unfixed_aat

    R = np.zeros((B, k, n))
    for b in range(B):   # k ≤ n: R (k, n) upper trapezoidal of rank k (0 in lane 3)
        U, _ = np.linalg.qr(rng.standard_normal((k, k)))
        V, _ = np.linalg.qr(rng.standard_normal((n, n)))
        R[b] = np.linalg.qr((U * np.logspace(0, 1, k) * (b != 3)) @ V[:k])[1]
    delta = t(np.where(np.arange(B) % 4 == 1, 0.02, 2.0))
    active = torch.as_tensor(np.arange(B) % 7 != 6, device=dev)
    return (t(R), A, factor_unfixed_aat(A, fixed), fixed, x, s, g, xl, xu, delta), active


def _minor_small_case(rng, B, k, m, n, dev):
    """`_minor_case` near criticality: g 1e5 times shorter, so that every
    component of the CG direction (~1e-5) lies below sqrt(eps) of float32
    (3.45e-4, the curvature test's tolerance) and above 1e-10 (the box's,
    factor_to_boundary's), s = 0, and a trust radius of 1e-6 on three lanes
    of four (the box binds) and 2 on the rest (interior solves)."""
    (R, A, L, fixed, x, s, g, xl, xu, delta), active = _minor_case(rng, B, k, m, n, dev)
    delta = torch.where(torch.arange(B, device=dev) % 4 == 0, 2.0, 1e-6).to(delta.dtype)
    return (R, A, L, fixed, x, torch.zeros_like(s), g * 1e-5, xl, xu, delta), active


def _box_at_curvature_tol(plain, args, kappa2, active):
    """The plain version's statuses with the box's threshold set to the
    curvature test's sqrt(eps): a kernel that mixed the two up."""
    from benlsip_tpu_torch.solver import cg

    exact = cg.factor_to_boundary
    cg.factor_to_boundary = functools.partial(exact, atol=torch.finfo(torch.float32).eps ** 0.5)
    try:
        return plain(*args, kappa2, active)[1]
    finally:
        cg.factor_to_boundary = exact


def _minor_compare(tag: str, got, want, want64, max_flips=MINOR_TRIP_FLIPS) -> dict:
    """The kernel's (w, status, trips) against the plain version's, lane by
    lane, as MINOR_W_RTOL's note says: equal statuses; at most `max_flips`
    lanes with other trips, each held to `want64` (the plain version's w in
    float64 on the same inputs), as is every lane whose float32 w differ by
    more than MINOR_W_RTOL.  Returns the worst relative error among the lanes
    that pass directly, and how many lanes passed against the float64 answer."""
    (w, st, it), (wp, stp, itp) = got, want
    _require(torch.equal(st, stp), f"{tag}: CG statuses differ from the plain version's on lanes "
             f"{torch.nonzero(st != stp).flatten().tolist()} ({st.tolist()} vs {stp.tolist()})")
    flips = torch.nonzero(it != itp).flatten().tolist()
    _require(len(flips) <= max_flips, f"{tag}: CG trips differ on {len(flips)} lanes {flips} (at most {max_flips})")
    same = it == itp
    scale = wp.abs().amax(-1, keepdim=True)
    err = ((w - wp).abs() / (scale + MINOR_W_ATOL / MINOR_W_RTOL)).amax(-1)
    _require(bool(torch.isfinite(w).all() == torch.isfinite(wp).all()), f"{tag}: non-finite w differs")
    direct = same & (err <= MINOR_W_RTOL)
    w64 = want64.to(w.dtype)
    d_k, d_p = (w - w64).abs().amax(-1), (wp - w64).abs().amax(-1)
    by64 = ~direct & (d_k <= MINOR_F64_FACTOR * d_p + MINOR_W_RTOL * w64.abs().amax(-1) + MINOR_W_ATOL)
    for i in torch.nonzero(~direct).flatten().tolist():
        print(f"{tag}: lane {i} ({int(it[i])} trips, plain {int(itp[i])}) off the plain float32 w by "
              f"{float(err[i]):.3e} of |w|_inf; against the float64 plain version: kernel {float(d_k[i]):.3e}, "
              f"plain float32 {float(d_p[i]):.3e}, |w|_inf {float(w64[i].abs().max()):.3e}")
    failed = torch.nonzero(~direct & ~by64).flatten().tolist()
    _require(not failed, f"{tag}: w off the plain version's on lanes {failed} by {err[failed].tolist()} of |w|_inf, "
             f"and off the float64 answer by {d_k[failed].tolist()} (plain float32 {d_p[failed].tolist()})")
    worst = float(err[direct].max()) if bool(direct.any()) else 0.0
    hist = collections.Counter(st.tolist())
    print(f"{tag}: statuses equal {dict(sorted(hist.items()))}, trips {int(it.sum())} (plain {int(itp.sum())}), "
          f"lanes with other trips {[(i, int(it[i]), int(itp[i])) for i in flips]}, worst |dw| / |w|_inf {worst:.3e}"
          f"{f', {int(by64.sum())} lanes held to the float64 answer' if bool(by64.any()) else ''}")
    return {"rel_err": worst, "trip_flips": len(flips), "by_f64": int(by64.sum())}


def _plain64(plain, args, kappa2, active):
    """The plain version's w in float64 on the same (float32) inputs."""
    args64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]
    return plain(*args64, kappa2, active)[0]


def _clone_call(args, kw):
    return ([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
            {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})


def _spied_calls(kern, name: str, run, head: int, tail: int):
    """Run `run()` with the kernel wrapper `kern.<name>` spied on: the
    clones of its first `head` and last `tail` calls' arguments, the number
    of calls, and run's result."""
    launch, first, last, count = getattr(kern, name), [], collections.deque(maxlen=tail), 0

    def record(*args, **kw):
        nonlocal count
        count += 1
        (first if len(first) < head else last).append(_clone_call(args, kw))
        return launch(*args, **kw)

    setattr(kern, name, record)
    try:
        out = run()
    finally:
        setattr(kern, name, launch)
    return first, list(last), count, out


def _record_minor_calls(kern, calls: int) -> list:
    """Config 3's real inputs to the minor-iteration kernel, cloned, from
    `dense_quadratic_family(64, n=192, d=1024, m=6, seed=3)`: the first and
    the last `calls` // 2 minor iterations of `solve_mixed_precision`'s
    float32 bulk (float64 master data, the eager route: the calls the
    benchmark's cell makes), then the last `calls` // 2 of a float32
    `solve_batched` run on towards its own criticality tolerance (sqrt(eps)
    of float32, 3.45e-4; 10 outer iterations at most), whose late minor
    iterations see g large and w small.  The solves run each minor loop as
    one `minor_loop_r` launch; the loops kept (as many as the minor
    iterations wanted, from each end) are run again through the loop's plain
    version, whose trips launch `minor_direction_r`, and those launches'
    inputs are what is kept."""
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev, opts = torch.device("cuda:0"), SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp, theta, X0 = dense_quadratic_family(64, n=192, d=1024, m=6, seed=3, dtype=torch.float64, device=dev)
    bp32, th32, X32 = dense_quadratic_family(64, n=192, d=1024, m=6, seed=3, dtype=torch.float32, device=dev)
    kept = []
    for tag, solve, head in (("solve_mixed_precision", lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=64),
                              calls // 2),
                             ("solve_batched", lambda: solve_batched(bp32, th32, X32, dataclasses.replace(opts, max_outer_iter=10)),
                              0)):
        tail = calls - calls // 2
        first_loops, last_loops, loops, out = _spied_calls(kern, "minor_loop_r", solve, head, tail)
        _require(loops > 0, f"config 3's {tag} made no call of the minor-loop kernel")
        replay = lambda group: _spied_calls(kern, "minor_direction_r",
                                            lambda: [kern._MINOR_LOOP_PLAIN(*a, **kw) for a, kw in group], 10 ** 6, 0)[0]
        first = replay(first_loops)[:head]
        last = replay(last_loops)[-tail:]
        _require(len(first) + len(last) > 0, f"config 3's {tag}: the plain loop made no minor iteration")
        print(f"minor_direction_r: config 3's {tag} ({int(out[2].converged.sum())}/64 converged) made {loops} minor-loop "
              f"calls; kept the first {len(first)} and the last {len(last)} minor iterations of their plain loops")
        kept += first + last
    return kept


def _check_minor(kern, rng, worst) -> list:
    """The minor-iteration kernel against its plain version on the card:
    synthetic inputs at MINOR_CHECKS's shapes (every CG exit, inactive
    lanes), each lane alone bitwise equal to the same lane in its batch, two
    calls bitwise equal; directions below sqrt(eps) against a tight box
    (`_minor_small_case`); then config 3's real inputs (`_record_minor_calls`);
    refused operands.  Returns the recorded calls."""
    from benlsip_tpu_torch.solver.status import CG_BOUND_HIT

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    plain = kern._MINOR_PLAIN
    for B, k, m, n in MINOR_CHECKS:
        args, active = _minor_case(rng, B, k, m, n, dev)
        for kappa2 in (0.1, 1e-3):
            got = kern.minor_direction_r(*args, kappa2, active=active)
            want = plain(*args, kappa2, active)
            flips = MINOR_TRIP_FLIPS if kappa2 == 0.1 else max(MINOR_TRIP_FLIPS, int(MINOR_FLIP_SHARE * B))
            r = _minor_compare(f"minor_direction_r {B}x{k}x{m}x{n} kappa2={kappa2:g}", got, want,
                               _plain64(plain, args, kappa2, active), flips)
            worst("minor_direction_r", r["rel_err"])
            again = kern.minor_direction_r(*args, kappa2, active=active)
            _require(all(torch.equal(a, b) for a, b in zip(got, again)), "minor_direction_r: two calls differ")
        if B > 1:
            lane = B // 2
            alone = kern.minor_direction_r(*[a[lane:lane + 1] for a in args], 0.1, active=active[lane:lane + 1])
            batch = kern.minor_direction_r(*args, 0.1, active=active)
            _require(all(torch.equal(a[0], b[lane]) for a, b in zip(alone, batch)),
                     f"minor_direction_r {B}x{k}x{m}x{n}: a lane alone differs from the same lane in its batch")
    # Directions below the curvature test's tolerance against a tight box:
    # the box still binds (factor_to_boundary's 1e-10), and the case tells
    # that from a box at sqrt(eps) (the plain version so altered differs).
    for B, k, m, n in ((64, 192, 6, 192), (64, 96, 3, 96)):
        args, active = _minor_small_case(rng, B, k, m, n, dev)
        for kappa2 in (0.1, 1e-3):
            tag = f"minor_direction_r small directions {B}x{k}x{m}x{n} kappa2={kappa2:g}"
            got = kern.minor_direction_r(*args, kappa2, active=active)
            want = plain(*args, kappa2, active)
            flips = MINOR_TRIP_FLIPS if kappa2 == 0.1 else max(MINOR_TRIP_FLIPS, int(MINOR_FLIP_SHARE * B))
            r = _minor_compare(tag, got, want, _plain64(plain, args, kappa2, active), flips)
            worst("minor_direction_r", r["rel_err"])
            loose = _box_at_curvature_tol(plain, args, kappa2, active)
            hits = int((want[1] == CG_BOUND_HIT).sum())
            print(f"{tag}: |g| max {float(args[6].abs().max()):.2e}, {hits} bound hits; a box at sqrt(eps) "
                  f"would change {int((loose != want[1]).sum())} statuses")
            _require(hits > 0 and bool((loose != want[1]).any()),
                     f"{tag}: the case does not tell the box's threshold from the curvature test's")
    calls = _record_minor_calls(kern, MINOR_RECORDED)
    worst_real, flips, lanes, by64 = 0.0, 0, 0, 0
    for i, (args, kw) in enumerate(calls):
        got = kern.minor_direction_r(*args, **kw)
        want = plain(*args, kw.get("active"))
        r = _minor_compare(f"minor_direction_r config 3 call {i}", got, want,
                           _plain64(plain, args[:10], args[10], kw.get("active")))
        worst_real, flips, lanes = max(worst_real, r["rel_err"]), flips + r["trip_flips"], lanes + args[0].shape[0]
        by64 += r["by_f64"]
    worst("minor_direction_r", worst_real)
    print(f"minor_direction_r: config 3's {len(calls)} recorded calls ({lanes} lanes): statuses equal, "
          f"{flips} lanes with other trips, worst |dw| / |w|_inf {worst_real:.3e} where within {MINOR_W_RTOL:g}, "
          f"{by64} lanes held to the float64 answer instead")
    args, active = _minor_case(rng, 4, 192, 6, 192, dev)
    before = kern.LAUNCHES["minor_direction_r"]
    for bad in ((args[0].double(),) + args[1:], (args[0].mT,) + args[1:],
                (args[0][:, :, :100],) + args[1:], (torch.zeros(4, 257, 257, device=dev),) + args[1:]):
        try:
            kern.minor_direction_r(*bad, 0.1)
        except (TypeError, ValueError):
            continue
        raise AssertionError("minor_direction_r: a refused operand was taken")
    _require(kern.LAUNCHES["minor_direction_r"] == before, "minor_direction_r: a refused call launched")
    print(f"minor_direction_r checks: {time.perf_counter() - t0:.1f} s")
    return calls


def _minor_bound(args, trips) -> dict:
    """The least time of one call: R, A (once if shared), L, the n-vectors
    and the mask read, w written, at the memory rate; or its flops — R p and
    Rᵀ(R p), 4kn, a CG trip the call ran, and R w, 2kn, a lane — at the
    float32 rate; whichever is larger."""
    R, A, L = args[0], args[1], args[2]
    B, k, n = R.shape
    m = A.shape[1]
    n_bytes = 4 * (B * k * n + (m * n if A.stride(0) == 0 else B * m * n) + B * m * m + 6 * B * n + B) + B * n
    return _bound(n_bytes, 4 * k * n * int(trips.sum()) + 2 * k * n * B)


def _captured_stage(name: str, fn):
    """fn captured as a stage of the fused pipeline (a CUDA graph whose
    loops are conditional WHILE nodes), after one plain run; the stage and
    the device operations one replay runs."""
    from benlsip_tpu_torch.batch import fused_small

    stage = fused_small._Stage(name, fn)
    fn()
    stage.capture(torch.cuda.graph_pool_handle(), torch.cuda.Stream())
    for _ in range(3):
        stage()
    _sync()
    stage.reset_counts()
    stage()
    _, kernels, copies, by_kind = stage.counts()
    return stage, {"device_kernels": kernels, "device_copies": copies, "while_trips": by_kind["while"]}


def _time_minor(kern, rng, rec, calls) -> None:
    """The minor-iteration kernel at config 3's shape on its real inputs
    (the recorded call with the most CG trips) and on synthetic ones: device
    µs a call (torch.profiler), the same call captured into a graph and
    replayed (CUDA events), the plain version eagerly (host-paced), and the
    old site — the plain version captured as the fused bulk captures it, its
    CG loop a WHILE node — replayed, with the device operations a replay
    runs; beside the bound."""
    plain = kern._MINOR_PLAIN
    trips = [int(kern.minor_direction_r(*a, **kw)[2].sum()) for a, kw in calls]
    best = max(range(len(calls)), key=lambda i: trips[i])
    synth, active = _minor_case(rng, 64, 192, 6, 192, dev=torch.device("cuda:0"))
    cases = {"config 3 recorded": calls[best], "synthetic": ([*synth, 0.1], {"active": active})}
    rec["minor_direction_r"]["times"] = {}
    for tag, (args, kw) in cases.items():
        base, kappa2, act = args[:10], args[10], kw.get("active")
        kernel = lambda: kern.minor_direction_r(*base, kappa2, active=act)
        old = lambda: plain(*base, kappa2, act)
        cg_trips = kernel()[2]
        us = _device_us(kernel)
        new_stage, new_ops = _captured_stage("minor_kernel", kernel)
        old_stage, old_ops = _captured_stage("minor_old_site", old)
        t = _in_turns({"kernel": kernel, "kernel graph": new_stage, "old site graph": old_stage, "plain": old},
                      reps=20, warm=3)
        bound = _minor_bound(base, cg_trips)
        rec["minor_direction_r"]["times"][tag] = {
            "shape": "x".join(map(str, (*base[0].shape, base[1].shape[1]))), "cg_trips": int(cg_trips.sum()),
            "device_us": us, "kernel_ms": t["kernel"], "kernel_graph_ms": t["kernel graph"],
            "old_site_graph_ms": t["old site graph"], "plain_ms": t["plain"], "old_site_ops": old_ops,
            "kernel_graph_ops": new_ops, **bound}
        print(f"minor_direction_r {tag} {tuple(base[0].shape)} m={base[1].shape[1]}: {int(cg_trips.sum())} CG trips over "
              f"the lanes (max {int(cg_trips.max())}); device {us:.2f} us a call (bound {bound['bound_us']:.2f} us by "
              f"{bound['bound_by']}, {100 * bound['bound_us'] / us:.1f}%); in turns: kernel {t['kernel']:.4f} ms, in a graph "
              f"{t['kernel graph']:.4f} ms ({new_ops}), old site in a graph {t['old site graph']:.4f} ms ({old_ops}), "
              f"plain eagerly {t['plain']:.4f} ms")


# Phase 3c, continued: the minor-loop kernel (`minor_loop_r`)
# ---------------------------------------------------------------------------

# The loop kernel against its plain version on the card, the masked loop of
# solver/inner (today's loop there: each trip one minor_direction_r launch,
# the product with H by torch's bmm, the norms by torch's reductions), lane by
# lane on each cell's recorded inputs.  The two sum R s and the norms in
# another order, so a lane whose approx_solved test, bound mask or CG exit
# lands on the other side of its threshold takes another path, and from there
# the two runs part (on densesphere's inputs near criticality, on an H100,
# one lane of 64 ended after 3 trips where the plain version took 7, with 13
# other bounds fixed and 20% less model reduction; neither float32 path is
# the float64 one there).  So at most MINOR_LOOP_FLIP_SHARE
# of a call's lanes may end with other trips, another CG status or another
# fixed set (or s off by more than MINOR_LOOP_S_RTOL), each printed with both
# model reductions, and each held to what the loop guarantees whatever its
# path: s inside the box and the trust region, A s where it was at entry
# (every direction lies in A's null space; within MINOR_LOOP_AS_RTOL of
# ‖A‖·‖s − s0‖), and the model gᵀs + ½‖R s‖² (in float64) no higher than at
# the entry s0.  Every other lane: equal trips, CG trips within one a trip
# of the plain version's (a CG's own exit flips as in MINOR_W_RTOL's note),
# equal status and fixed set, and s within MINOR_LOOP_S_RTOL of its ‖s‖∞.
# On every lane, bitwise: L is the masked_aat_cholesky kernel's factor of the
# returned fixed set (the same device code), and a lane not run returns its
# entry carry; g_minor is Rᵀ(R s) + g within MINOR_LOOP_S_RTOL of ‖g_minor‖∞.
MINOR_LOOP_S_RTOL = 2e-3
MINOR_LOOP_AS_RTOL = 1e-4
MINOR_LOOP_FLIP_SHARE = 0.1
MINOR_LOOP_BOX_ATOL = 1e-6
# Calls of the loop kernel recorded from each cell's eager pipeline: the
# first and the last MINOR_LOOP_RECORDED // 2.
MINOR_LOOP_RECORDED = 24
MINOR_LOOP_CELLS = ("densequad-b64-fused", "densesphere-b64-fused")


def _cell_pool(cell: str, seed: int, dev):
    """The benchmark cell's configuration, traffic, pool (portbench's
    family, `seed`) and solver options."""
    from benlsip_tpu_torch.solver.options import SolverOptions
    from portbench.families import densequad, densesphere

    bench = json.loads(open("BENCHMARK.json").read())
    work = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = json.loads(open(conf["file"]).read())
    mix = json.loads(open(f"portbench/traffic/{work['traffic']}.json").read())
    family = {"densequad": densequad, "densesphere": densesphere}[cfg["family"]]
    return cfg, mix, family.Pool(cfg, mix, seed, dev), SolverOptions(**cfg["options"])


def _record_loop_calls(kern, cell: str, calls: int) -> list:
    """The cell's real inputs to the minor-loop kernel, cloned: the first
    and the last `calls` // 2 launches of one eager `solve_mixed_precision`
    (the cell's chunk, unfused) of its pool's first batch (seed 1)."""
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision

    _, mix, pool, opts = _cell_pool(cell, 1, torch.device("cuda:0"))
    bp, theta, X0 = pool.batch(0)
    first, last, count, out = _spied_calls(
        kern, "minor_loop_r", lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=mix["route"]["chunk"]),
        calls // 2, calls - calls // 2)
    _require(count > 0, f"{cell}: the eager pipeline made no call of the minor-loop kernel")
    print(f"minor_loop_r: {cell}'s eager pipeline ({int(out[2].converged.sum())}/{X0.shape[0]} certified) made "
          f"{count} calls; kept the first {len(first)} and the last {len(last)}")
    return first + last


def _bits_equal(u: torch.Tensor, v: torch.Tensor) -> bool:
    """Bitwise equal, NaNs in the same places counting as equal (a lane
    whose every column is fixed has a NaN factor)."""
    if u.shape != v.shape or u.dtype != v.dtype:
        return False
    if u.is_floating_point():
        return bool(((u == v) | (torch.isnan(u) & torch.isnan(v))).all())
    return torch.equal(u, v)


def _loop_pred(args, s):
    """The model reduction gᵀs + ½‖R s‖² of each lane, in float64."""
    R, g = args[0].double(), args[6].double()
    Rs = (R @ s.double().unsqueeze(-1)).squeeze(-1)
    return (g * s.double()).sum(-1) + 0.5 * (Rs * Rs).sum(-1)


def _loop_compare(kern, tag: str, args, got, want) -> dict:
    """The loop kernel's outputs against the plain version's, lane by lane,
    as MINOR_LOOP_S_RTOL's note says."""
    R, A, L0, fixed0, x, s0, g, gm0, xl, xu, delta, run, max_minor = args[:13]
    reg = args[16]
    s, gm, fixed, L, it, cg, st = got
    sp, gmp, fixedp, Lp, itp, cgp, stp = want
    B = s.shape[0]
    same_path = (it == itp) & (st == stp) & (fixed == fixedp).all(-1)
    scale = sp.abs().amax(-1)
    err = (s - sp).abs().amax(-1) / (scale + MINOR_W_ATOL / MINOR_LOOP_S_RTOL)
    cg_ok = (cg - cgp).abs() <= it
    direct = same_path & cg_ok & (err <= MINOR_LOOP_S_RTOL)
    pred, predp, pred0 = _loop_pred(args, s), _loop_pred(args, sp), _loop_pred(args, s0)
    lo = torch.maximum(xl - x, -delta.unsqueeze(-1))
    hi = torch.minimum(xu - x, delta.unsqueeze(-1))
    inside = ((s >= lo - MINOR_LOOP_BOX_ATOL) & (s <= hi + MINOR_LOOP_BOX_ATOL)).all(-1)
    ds = (s - s0).double()
    a_move = (A.double() @ ds.unsqueeze(-1)).squeeze(-1).abs().amax(-1)
    a_tol = MINOR_LOOP_AS_RTOL * A.double().abs().sum(-1).amax(-1) * ds.abs().amax(-1) + 1e-12
    by_model = ~direct & inside & (a_move <= a_tol) & (pred <= pred0 + 1e-9 * pred0.abs())
    for i in torch.nonzero(~direct).flatten().tolist():
        print(f"{tag}: lane {i}: trips {int(it[i])} (plain {int(itp[i])}), CG trips {int(cg[i])} ({int(cgp[i])}), "
              f"status {int(st[i])} ({int(stp[i])}), fixed sets differ in {int((fixed[i] != fixedp[i]).sum())}, "
              f"|ds|/|s|_inf {float(err[i]):.3e}; model reduction {float(pred[i]):.6e} (plain {float(predp[i]):.6e}, "
              f"entry {float(pred0[i]):.6e}), |A (s - s0)|_inf {float(a_move[i]):.3e} (limit {float(a_tol[i]):.3e})")
    others = int((~direct).sum())
    _require(others <= max(2, int(MINOR_LOOP_FLIP_SHARE * B)),
             f"{tag}: {others} of {B} lanes off the plain version's path (at most {MINOR_LOOP_FLIP_SHARE:g} of them)")
    failed = torch.nonzero(~direct & ~by_model).flatten().tolist()
    _require(not failed, f"{tag}: lanes {failed} neither follow the plain version nor keep the loop's guarantees "
             f"(|ds|/|s|_inf {err[failed].tolist()}, reductions {pred[failed].tolist()} vs entry {pred0[failed].tolist()})")
    # Bitwise: the factor of the returned set, and the carry of a lane not run.
    _require(_bits_equal(L, kern.masked_aat_cholesky(A, fixed, reg)),
             f"{tag}: L is not the masked_aat_cholesky kernel's factor of the returned fixed set")
    idle = ~run
    for name, out, entry in (("s", s, s0), ("g_minor", gm, gm0), ("fixed", fixed, fixed0), ("L", L, L0)):
        same = out[idle] == entry[idle]
        if out.is_floating_point():
            same |= torch.isnan(out[idle]) & torch.isnan(entry[idle])
        _require(bool(same.all()), f"{tag}: a lane not run changed its {name}")
    _require(not bool(it[idle].any()) and not bool(cg[idle].any()), f"{tag}: a lane not run counted trips")
    gm_ref = (R.mT @ (R @ s.unsqueeze(-1))).squeeze(-1) + g
    gm_err = float(((gm - gm_ref).abs().amax(-1) / (gm_ref.abs().amax(-1) + 1e-30)).max())
    _require(gm_err <= MINOR_LOOP_S_RTOL, f"{tag}: g_minor off Rᵀ(R s) + g by {gm_err:.3e} of |g_minor|_inf")
    worst = float(err[direct].max()) if bool(direct.any()) else 0.0
    return {"rel_err": worst, "off_path": others, "by_model": int(by_model.sum()), "trips": int(it.sum()),
            "plain_trips": int(itp.sum()), "cg_trips": int(cg.sum()), "plain_cg_trips": int(cgp.sum()),
            "max_trips": int(it.max()), "gm_rel_err": gm_err}


def _check_minor_loop(kern, worst) -> dict:
    """The minor-loop kernel against its plain version on the card at both
    cells' recorded inputs (`_record_loop_calls`): each call as recorded,
    again with every other lane held back at entry (they return their entry
    carry), two calls bitwise equal, a lane alone bitwise its lane in the
    batch; then refused operands.  Returns the recorded calls by cell."""
    t0 = time.perf_counter()
    plain = kern._MINOR_LOOP_PLAIN
    recorded = {}
    for cell in MINOR_LOOP_CELLS:
        calls = _record_loop_calls(kern, cell, MINOR_LOOP_RECORDED)
        recorded[cell] = calls
        tot = collections.Counter()
        for i, (args, kw) in enumerate(calls):
            for held in (False, True):
                a = list(args)
                if held:
                    a[11] = a[11] & (torch.arange(a[11].shape[0], device=a[11].device) % 2 == 0)
                got = kern.minor_loop_r(*a, **kw)
                r = _loop_compare(kern, f"minor_loop_r {cell} call {i}{' (odd lanes held)' if held else ''}", a, got,
                                  plain(*a, **kw))
                worst("minor_loop_r", r["rel_err"])
                tot.update({k: v for k, v in r.items() if k not in ("rel_err", "gm_rel_err", "max_trips")})
                tot["max_trips"] = max(tot["max_trips"], r["max_trips"])
                tot["calls"] += 1
            once, again = kern.minor_loop_r(*args, **kw), kern.minor_loop_r(*args, **kw)
            _require(all(_bits_equal(u, v) for u, v in zip(once, again)), f"minor_loop_r {cell} call {i}: two calls differ")
            lane = args[0].shape[0] // 2
            alone = kern.minor_loop_r(*[t[lane:lane + 1] if isinstance(t, torch.Tensor) else t for t in args], **kw)
            _require(all(_bits_equal(u[0], v[lane]) for u, v in zip(alone, again)),
                     f"minor_loop_r {cell} call {i}: a lane alone differs from the same lane in its batch")
        print(f"minor_loop_r {cell}: {tot['calls']} checks of {len(calls)} recorded calls: trips {tot['trips']} (plain "
              f"{tot['plain_trips']}, most a lane {tot['max_trips']}), CG trips {tot['cg_trips']} (plain "
              f"{tot['plain_cg_trips']}), {tot['off_path']} lanes off the plain path ({tot['by_model']} held to the model)")
    args, kw = recorded[MINOR_LOOP_CELLS[0]][0]
    before = kern.LAUNCHES["minor_loop_r"]
    for i, bad in ((0, args[0].double()), (0, args[0].mT), (12, args[12].long()), (11, args[11].int()),
                   (7, args[7][:, :-1])):
        a = list(args)
        a[i] = bad
        try:
            kern.minor_loop_r(*a, **kw)
        except (TypeError, ValueError):
            continue
        raise AssertionError("minor_loop_r: a refused operand was taken")
    _require(kern.LAUNCHES["minor_loop_r"] == before, "minor_loop_r: a refused call launched")
    print(f"minor_loop_r checks: {time.perf_counter() - t0:.1f} s")
    return recorded


def _minor_loop_bound(args, iters, cg_iters) -> dict:
    """The least time of one loop call: R, A (once if shared), L, the
    n-vectors and the mask read, the carry written, at the memory rate; or
    its flops — per trip R w and Rᵀ(R s) (2kn + 4kn) and 4kn a CG trip —
    at the float32 rate; whichever is larger."""
    R, A = args[0], args[1]
    B, k, n = R.shape
    m = A.shape[1]
    n_bytes = 4 * (B * k * n + (m * n if A.stride(0) == 0 else B * m * n) + 2 * B * m * m + 10 * B * n + 4 * B) + 2 * B * n
    return _bound(n_bytes, 6 * k * n * int(iters.sum()) + 4 * k * n * int(cg_iters.sum()))


def _time_minor_loop(kern, rec, recorded) -> None:
    """The minor-loop kernel at each cell's recorded call with the most
    trips: device µs a launch (torch.profiler), the same call captured into
    a graph and replayed, and the old site — the plain version captured as
    the fused bulk captures it (the minor WHILE node, its trips' CG inside
    minor_direction_r) — replayed, with the device operations a replay runs;
    beside the bound."""
    plain = kern._MINOR_LOOP_PLAIN
    rec["minor_loop_r"]["times"] = {}
    for cell, calls in recorded.items():
        trips = [int(kern.minor_loop_r(*a, **kw)[4].max()) for a, kw in calls]
        args, kw = calls[max(range(len(calls)), key=lambda i: trips[i])]
        kernel = lambda: kern.minor_loop_r(*args, **kw)
        old = lambda: plain(*args, **kw)
        out = kernel()
        us = _device_us(kernel)
        new_stage, new_ops = _captured_stage("minor_loop_kernel", kernel)
        old_stage, old_ops = _captured_stage("minor_loop_old_site", old)
        t = _in_turns({"kernel graph": new_stage, "old site graph": old_stage}, reps=20, warm=3)
        bound = _minor_loop_bound(args, out[4], out[5])
        rec["minor_loop_r"]["times"][cell] = {
            "shape": "x".join(map(str, (*args[0].shape, args[1].shape[1]))), "trips": int(out[4].sum()),
            "max_trips": int(out[4].max()), "cg_trips": int(out[5].sum()), "device_us": us,
            "kernel_graph_ms": t["kernel graph"], "old_site_graph_ms": t["old site graph"], "old_site_ops": old_ops,
            "kernel_graph_ops": new_ops, **bound}
        print(f"minor_loop_r {cell} {tuple(args[0].shape)} m={args[1].shape[1]}: {int(out[4].sum())} trips over the "
              f"lanes (max {int(out[4].max())}), {int(out[5].sum())} CG trips; device {us:.2f} us a launch (bound "
              f"{bound['bound_us']:.2f} us by {bound['bound_by']}, {100 * bound['bound_us'] / us:.1f}%); in turns: in a "
              f"graph {t['kernel graph']:.4f} ms ({new_ops}), old site in a graph {t['old site graph']:.4f} ms ({old_ops})")


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


def _contraction(S, R) -> float:
    """max over the batch of ‖R⁻ᵀ(SᵀS − RᵀR)R⁻¹‖₂ in float64: the
    contraction of the polish's chord step built on R."""
    Sd, Rd = S.double(), R.double()
    Rinv = torch.linalg.inv(Rd)
    return float(torch.linalg.matrix_norm(Rinv.mT @ (Sd.mT @ Sd - Rd.mT @ Rd) @ Rinv, ord=2).max())


def _check_blocked_qr(kern, rng, worst) -> None:
    """The panel QR kernel against its plain version, against the library's
    R and against SᵀS."""
    dev = torch.device("cuda:0")
    normal = lambda B, D, N: torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float32, device=dev)
    cases = {
        "64x1216x192 polish-shaped": polish_stack(rng, 64, 1024, 192, dev),
        "8x300x17": normal(8, 300, 17),                  # one ragged panel
        "5x2048x256 (the gate's corner, a cluster of 4)": normal(5, 2048, 256),
        "3x40x40 square": normal(3, 40, 40),
        "6x534x150": normal(6, 534, 150),                # D not a multiple of 4, ragged last panel
        "4x1540x70 (a cluster of 4, ragged)": normal(4, 1540, 70),
        "4x600x96 kappa=1e4": conditioned(rng, 4, 600, 96, 1e4, dev),
        "1x300x40 one instance": normal(1, 300, 40),
        "2x3000x70 (a cluster of 8, outside qr_r's gate)": normal(2, 3000, 70),
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
        print(f"blocked_qr_r {tag}: plan {kern.blocked_qr_plan(S.shape[1], S.shape[2], S.dtype)}, vs plain {err:.3e}, "
              f"vs library {c['err']:.3e} (tol {c['tol']:.3e}, κ {c['kappa']:.3e}, max|R| {c['scale']:.3e}), "
              f"Gram {c['gram']:.3e} (plain {cp['gram']:.3e}, tol {2 * S.shape[2] * EPS32:.3e})")

    # Ragged last panels, ill-conditioned: with one block projection pass
    # against the finished panels the contraction reached 1e2·κ·eps here,
    # with two but without the CholeskyQR step on each finished panel
    # 8·κ·eps at κ = 1e6 (on the CPU); the kernel must keep it under
    # 2·κ·eps, a bound the library's Householder R meets on the same S.
    # N = 36-48 were ragged at the old panel width of 32 and are one panel
    # at 64; 70, 100 and 136 are ragged at 64.
    for N in (36, 40, 48, 70, 100, 136):
        for kappa in (1e4, 1e5, 1e6):
            tag = f"4x300x{N} kappa={kappa:.0e}"
            S = conditioned(rng, 4, 300, N, kappa, dev)
            R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
            c = _check_r(f"blocked_qr_r {tag}", R, S)
            _check_r(f"blocked_qr_r_plain {tag}", Rp, S)
            err = float((R - Rp).abs().max())
            if err > c["tol"]:
                raise AssertionError(f"blocked_qr_r {tag}: kernel disagrees with its plain version ({err:.3e} > {c['tol']:.3e})")
            worst("blocked_qr_r", err)
            con = {k: _contraction(S, M) / (kappa * EPS32) for k, M in (("kernel", R), ("plain", Rp), ("library", _library_r(S)))}
            print(f"blocked_qr_r {tag}: chord contraction in kappa*eps: kernel {con['kernel']:.3f}, plain {con['plain']:.3f}, "
                  f"library {con['library']:.3f} (bound 2); vs plain {err:.3e} (tol {c['tol']:.3e})")
            if con["kernel"] > 2 or con["plain"] > 2:
                raise AssertionError(f"blocked_qr_r {tag}: chord contraction above 2*kappa*eps: {con}")

    # The 40 seeded draws of scripts/blocked_qr_contraction.py at
    # (4, 300, 36), where two passes without the CholeskyQR step reached
    # 3.5·κ·eps (κ = 1e5) and 8·κ·eps (κ = 1e6) on the CPU: every draw
    # under 2·κ·eps, kernel and plain version, and the kernel within the
    # κ-scaled tolerance of its plain version.
    for kappa in (1e5, 1e6):
        draws = np.random.default_rng([0, 36, int(kappa)])
        con, worst_err = {"kernel": [], "plain": []}, 0.0
        for _ in range(40):
            U = np.linalg.qr(draws.standard_normal((4, 300, 36)))[0]
            V = np.linalg.qr(draws.standard_normal((4, 36, 36)))[0]
            S = torch.as_tensor(((U * np.logspace(0.0, -np.log10(kappa), 36)) @ np.transpose(V, (0, 2, 1)))
                                .astype(np.float32), device=dev)
            R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
            tol = 4 * EPS32 * (math.sqrt(300) + kappa) * float(Rp.abs().max())
            err = float((R - Rp).abs().max())
            if err > tol:
                raise AssertionError(f"blocked_qr_r 4x300x36 kappa={kappa:.0e}: kernel off its plain version by {err:.3e} > {tol:.3e}")
            worst_err = max(worst_err, err / tol)
            con["kernel"].append(_contraction(S, R) / (kappa * EPS32))
            con["plain"].append(_contraction(S, Rp) / (kappa * EPS32))
        print(f"blocked_qr_r 4x300x36 kappa={kappa:.0e}, 40 seeded draws: chord contraction in kappa*eps, kernel median "
              f"{np.median(con['kernel']):.3f} max {max(con['kernel']):.3f}, plain median {np.median(con['plain']):.3f} "
              f"max {max(con['plain']):.3f} (bound 2); kernel vs plain at most {worst_err:.3f} of its tolerance")
        if max(con["kernel"]) > 2 or max(con["plain"]) > 2:
            raise AssertionError(f"blocked_qr_r 4x300x36 kappa={kappa:.0e}: a draw's chord contraction is above 2*kappa*eps")

    # float64 through the same source (panels of 32 columns on the CUDA
    # cores): one to four panels, one to four blocks an instance.
    for B, D, N in ((4, 600, 50), (3, 2048, 40), (2, 300, 100)):
        S = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=torch.float64, device=dev)
        c = _check_r(f"blocked_qr_r float64 {B}x{D}x{N}", kern.blocked_qr_r(S), S)
        print(f"blocked_qr_r float64 {B}x{D}x{N}: plan {kern.blocked_qr_plan(D, N, S.dtype)}, vs library {c['err']:.3e}, "
              f"Gram {c['gram']:.3e}")

    # The stacked form: R of [JZ; diag(dbot)] from JZ and dbot, bitwise the R
    # of the materialized stack, at the polish's shape and at a ragged one
    # (D and N off every tile); an instance's R alone, in a batch of 4 and in
    # a permuted batch of 64 bitwise the batch's (the plan is the shape's).
    for B, d, N in ((64, 1024, 192), (5, 301, 70)):
        JZ = normal(B, d, N)
        dbot = _polish_dbot(rng, B, N, dev)
        Rs = kern.blocked_qr_r(JZ, dbot)
        _require(torch.equal(_bits(Rs), _bits(kern.blocked_qr_r(_stack(JZ, dbot)))),
                 f"blocked_qr_r stacked {B}x({d}+{N})x{N}: not bitwise the R of the materialized stack")
        _check_r(f"blocked_qr_r stacked {B}x({d}+{N})x{N}", Rs, _stack(JZ, dbot))
        err = float((Rs - kern.blocked_qr_r_plain(JZ, dbot)).abs().max())
        worst("blocked_qr_r", err)
        print(f"blocked_qr_r stacked {B}x({d}+{N})x{N}: bitwise the materialized stack's R, vs plain {err:.3e}")
    S = polish_stack(rng, 64, 1024, 192, dev)
    R = kern.blocked_qr_r(S)
    perm = torch.as_tensor(rng.permutation(64), device=dev)
    _require(torch.equal(_bits(kern.blocked_qr_r(S[perm].contiguous())), _bits(R[perm])),
             "blocked_qr_r 64x1216x192: a permuted batch differs from the batch's lanes")
    for b in (0, 31, 60):
        _require(torch.equal(_bits(kern.blocked_qr_r(S[b:b + 1].contiguous())), _bits(R[b:b + 1]))
                 and torch.equal(_bits(kern.blocked_qr_r(S[b:b + 4].contiguous())), _bits(R[b:b + 4])),
                 f"blocked_qr_r 64x1216x192: lane {b} alone or in a batch of 4 differs from the batch's")
    print("blocked_qr_r 64x1216x192: lanes alone, in batches of 4 and in a permuted batch of 64 bitwise the batch's")

    # A zero column gets the `tiny` floor on the diagonal and zeros beside it;
    # a NaN stays in its own instance.  A zero column in the first panel
    # (lane 1) makes that panel's Gram singular: its CholeskyQR step keeps
    # R₂ = I and the lane's R stays finite and agrees with the plain version.
    S = normal(6, 200, 80)
    S[1, :, 5] = 0.0
    S[2, :, 70] = 0.0
    S[4, 17, 3] = float("nan")
    R, Rp = kern.blocked_qr_r(S), kern.blocked_qr_r_plain(S)
    floor = math.sqrt(float(torch.finfo(torch.float32).tiny))
    if not (abs(float(R[2, 70, 70]) - floor) <= 1e-6 * floor and R[2, 70, 71:].abs().max() == 0
            and abs(float(R[1, 5, 5]) - floor) <= 1e-6 * floor and torch.isfinite(R[[0, 1, 2, 3, 5]]).all()):
        raise AssertionError("blocked_qr_r: a zero column must give sqrt(tiny) on the diagonal and a finite R")
    err = float((R[[0, 1, 2, 3, 5]] - Rp[[0, 1, 2, 3, 5]]).abs().max())
    if err > KERNEL_ATOL * float(Rp[[0, 1, 2, 3, 5]].abs().max()):
        raise AssertionError(f"blocked_qr_r: zero-column lanes off the plain version by {err:.3e}")
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
        lambda: kern.blocked_qr_r(normal(2, 50, 20), normal(2, 20, 1)[:, :, 0][:, :19]),     # dbot of the wrong shape
        lambda: kern.blocked_qr_r(normal(2, 50, 20), torch.ones((2, 20))),                   # dbot on the CPU
        lambda: kern.blocked_qr_r(normal(2, 50, 20), torch.ones((2, 20), dtype=torch.float64, device=dev)),
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
    each matrix the whole card, may win; 20 calls a turn; and the kernel's
    device µs a call at each shape (torch.profiler).  At the polish's shape
    also the stacked form (R of [JZ; diag(dbot)] from JZ and dbot) in turns
    with the route it replaced (`torch.cat` + `diag_embed`, then the kernel)."""
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
        us = _device_us(lambda: kern.blocked_qr_r(S), reps=20)
        bound = _panel_qr_bound(*S.shape)
        rec["blocked_qr_r"].update({
            "ms" + suffix: t["kernel"], "plain_ms" + suffix: t["plain"], "library_ms" + suffix: t["library"],
            "device_us" + suffix: us, **{k + suffix: bound[k] for k in ("bound_ms", "bound_us", "bound_by")},
        })
        shape = "x".join(map(str, S.shape))
        print(f"blocked_qr_r {shape}: kernel {t['kernel']:.4f} ms (device {us:.2f} us, plan "
              f"{kern.blocked_qr_plan(S.shape[1], S.shape[2], S.dtype)}), plain {t['plain']:.4f} ms, "
              f"library {t['library']:.4f} ms, bound {bound['bound_us']:.4f} us "
              f"({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop; all on FP32 FMA "
              f"{bound['bound_us_f32']:.4f} us)")
        if S.shape[0] >= kern.MIN_BLOCKED_QR_BATCH and t["kernel"] > t["library"]:
            raise AssertionError(f"blocked_qr_r {shape}: slower than the library call inside qr_r's gate")
    rec["blocked_qr_r"]["shape"] = "64x1216x192"
    # The polish's factor: one stacked launch against the materialized stack.
    B, d, n = 64, 1024, 192
    JZ = torch.as_tensor(rng.standard_normal((B, d, n)), dtype=torch.float32, device=dev)
    dbot = _polish_dbot(rng, B, n, dev)
    t = _in_turns({"stacked": lambda: kern.blocked_qr_r(JZ, dbot),
                   "materialized": lambda: kern.blocked_qr_r(_stack(JZ, dbot))}, reps=20, warm=3)
    us = {k: _device_us(f, reps=20) for k, f in (("stacked", lambda: kern.blocked_qr_r(JZ, dbot)),
                                                 ("materialized", lambda: kern.blocked_qr_r(_stack(JZ, dbot))))}
    rec["blocked_qr_r"].update({"ms_stacked": t["stacked"], "ms_materialized": t["materialized"],
                                "device_us_stacked": us["stacked"], "device_us_materialized": us["materialized"]})
    print(f"blocked_qr_r stacked {B}x({d}+{n})x{n}: {t['stacked']:.4f} ms (device {us['stacked']:.2f} us) against "
          f"torch.cat + diag_embed + the kernel {t['materialized']:.4f} ms (device {us['materialized']:.2f} us)")


def _time_kernels(kern, rng, rec) -> None:
    """Times at each path's shapes, in turns, with bounds and library calls.

    Config 2: the bulk factors and projects at the chunk width
    (512, m = 1, n = 3) with a per-instance A.  Config 3: (64, m = 6,
    n = 192) with one A shared by the batch (a stride-0 expand).  The narrow
    QR at every path's shapes in `_time_narrow_qr`."""
    dev = torch.device("cuda:0")
    f32 = torch.float32
    paths = {}
    for suffix, (B, m, n, shared) in {"": (512, 1, 3, False), "_config3": (64, 6, 192, True)}.items():
        A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        fixed[B - 2:] = fixed[0]     # no degenerate lanes in the timed batch
        if shared:                    # a generic shared matrix, as the path has
            A = torch.as_tensor(rng.standard_normal((m, n)), dtype=f32, device=dev).expand(B, m, n)
        L = kern.masked_aat_cholesky(A, fixed)
        K = (L @ L.mT).contiguous()
        b = torch.as_tensor(rng.standard_normal((B, m)), dtype=f32, device=dev)
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
            if name in ("masked_aat_cholesky", "project_tangent"):
                # The CUDA-event wall above is the wrapper's host time; the
                # warp form's own device time a call, by torch.profiler.
                rec[name]["device_us" + suffix] = _device_us(case["kernel"])
                print(f"{name} {case['shape']}: device {rec[name]['device_us' + suffix]:.3f} us a call")
            print(f"{name} {case['shape']}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
                  f"{yard.replace('_', ' ')} {t[yard]:.4f} ms, bound {case['bound']['bound_us']:.4f} us "
                  f"({case['bound']['bound_by']}: {case['bound']['bytes']} B, {case['bound']['flops']} flop)")
    _time_narrow_qr(kern, rng, rec)
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
    # Config 4: the solve at (1, 8) in the dual Newton; the fused kernels at
    # (1, 8, 10240) and the other large n in `_time_split`.
    m = 8
    L = kern.masked_aat_cholesky(*(t[:1].contiguous() for t in _fused_case(rng, 3, m, 64, False, dev)[:2]))
    b = torch.as_tensor(rng.standard_normal((1, m)), dtype=f32, device=dev)
    _time_extra(rec, "batched_cho_solve", (1, m), _bound((m * m + 2 * m) * 4, 2 * m * m), {
        "plain": lambda: kern.batched_cho_solve_plain(L, b), "kernel": lambda: kern.batched_cho_solve(L, b),
        "library": lambda: torch.cholesky_solve(b.unsqueeze(-1), L)})
    _time_split(kern, rng, rec)
    _time_newton(kern, rng, rec)


# The split form's shapes: one instance of m = 8 from n = 192 (config 3's
# width) to 40,960 (the JAX package's sharded-Gram size), config 4's 10,240
# among them, and a batch of large n; the cluster sizes tried at each.
SPLIT_SHAPES = ((1, 8, 192), (1, 8, 512), (1, 8, 1024), (1, 8, 2048), (1, 8, 10240), (1, 8, 40960), (130, 3, 5000))
SPLIT_CLUSTERS = (2, 4, 8, 16)


def _fused_bounds(B: int, m: int, n: int, n_free: int) -> dict:
    """Bounds of the fused kernels at (B, m, n), A per instance: the factor
    reads A and the mask and writes L; the projection reads A, L, the mask
    and r and writes the output."""
    return {
        "masked_aat_cholesky": _bound(B * (m * n * 4 + n + m * m * 4), m * (m + 1) * n_free + B * m ** 3 / 3),
        "project_tangent": _bound(B * (m * n * 4 + m * m * 4 + n + 2 * n * 4), 4 * m * n_free + 2 * B * m * m),
    }


def _reread_projection(kern, A, L, fixed, r, blocks: int):
    """The projection's split form with its second pass reading A from
    device memory, where the planned one keeps the slice in shared memory
    (`benlsip_project_tangent_reread_f32`, on no path): the other variant,
    timed beside the planned one."""
    fn = kern.load_library().benlsip_project_tangent_reread_f32
    fn.argtypes, fn.restype = kern._SIGNATURES["benlsip_project_tangent"], ctypes.c_int
    B, m, n = A.shape
    out = torch.empty_like(r)
    kern._check(fn(A.data_ptr(), A.stride(0) if B > 1 else 0, L.data_ptr(), fixed.data_ptr(), r.data_ptr(),
                   out.data_ptr(), B, m, n, 0, blocks, torch.cuda.current_stream().cuda_stream), "reread projection")
    return out


def _time_split(kern, rng, rec) -> None:
    """The fused kernels' two forms at each of SPLIT_SHAPES: the planned
    split form (the plan's cluster, or 2 blocks where the plan keeps the
    warp), the warp form and the old call site in turns with CUDA events
    (per turn, for the gate below); then each form's device time a call from
    torch.profiler, the warp form and every cluster size, beside the bound.
    At config 4's (1, 8, 10240) each split kernel must beat its old call site
    in every turn and take at most a tenth of the warp form's device time.
    The projection's reread variant (second pass from device memory) is
    timed beside the planned one (from shared memory) at the two widest
    single instances, and must give the same bits."""
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    for B, m, n in SPLIT_SHAPES:
        A, fixed, r = _fused_case(rng, max(B, 3), m, n, False, dev)
        fixed[-2:] = fixed[0]                # no degenerate lanes in a timed batch
        A, fixed, r = A[:B].contiguous(), fixed[:B].contiguous(), r[:B].contiguous()
        L = kern.masked_aat_cholesky(A, fixed)
        shape = f"{B}x{m}x{n}"
        plan = kern.fused_plan(m, n, torch.float32)
        S = plan if plan > 1 else 2
        bounds = _fused_bounds(B, m, n, int((~fixed).sum()))
        calls = {
            "masked_aat_cholesky": (lambda: kern.masked_aat_cholesky(A, fixed), lambda: old_factor_site(kern, A, fixed),
                                    lambda: kern.masked_aat_cholesky_plain(A, fixed)),
            "project_tangent": (lambda: kern.project_tangent(A, L, fixed, r), lambda: old_project_site(kern, A, L, fixed, r),
                                lambda: kern.project_tangent_plain(A, L, fixed, r)),
        }
        config4 = (B, m, n) == (1, 8, 10240)
        for name, (call, old, plain) in calls.items():
            # (function, forced plan or None); the plain version at config 4's shape only.
            fns = {"split": (call, S), "warp": (call, 1), "old_site": (old, None), **({"plain": (plain, None)} if config4 else {})}
            turns = {k: [] for k in fns}
            for k in list(fns) + list(fns)[::-1]:
                fn, blocks = fns[k]
                with _forced_plan(kern, blocks) if blocks else contextlib.nullcontext():
                    turns[k].append(_cuda_ms(fn))
            dev_us = {}
            for blocks in (1, *SPLIT_CLUSTERS):
                with _forced_plan(kern, blocks):
                    dev_us["warp" if blocks == 1 else f"S={blocks}"] = _device_us(call)
            bound = bounds[name]
            ms = {k: sum(v) / len(v) for k, v in turns.items()}
            key = f"_{shape}"
            rec[name].update({
                f"plan{key}": plan, f"ms{key}_S{S}": ms["split"], f"ms{key}_warp": ms["warp"],
                f"old_site_ms{key}": ms["old_site"], f"bound_us{key}": bound["bound_us"], f"bound_by{key}": bound["bound_by"],
                **{f"device_us{key}_{k.replace('=', '')}": v for k, v in dev_us.items()},
            })
            print(f"{name} {shape}: plan {plan}; events ms a call: split (S={S}) {ms['split']:.4f}, warp {ms['warp']:.4f}, "
                  f"old site {ms['old_site']:.4f}" + (f", plain {ms['plain']:.4f}" if config4 else "")
                  + f" (turns: split {['%.4f' % t for t in turns['split']]}, old site {['%.4f' % t for t in turns['old_site']]}); "
                  f"profiler device us a call: " + ", ".join(f"{k} {v:.2f}" for k, v in dev_us.items())
                  + f"; bound {bound['bound_us']:.4f} us ({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")
            if config4:
                if not all(a < b for a, b in zip(turns["split"], turns["old_site"])):
                    raise AssertionError(f"{name} {shape}: the split form is not faster than its old call site in every turn")
                if dev_us[f"S={plan}"] > dev_us["warp"] / 10:
                    raise AssertionError(f"{name} {shape}: the split form's device time {dev_us[f'S={plan}']:.2f} us is "
                                         f"above a tenth of the warp form's {dev_us['warp']:.2f} us")
                # The record's config-4 keys, as before the split form: the planned kernel.
                rec[name].update({f"ms{key}": ms["split"], f"plain_ms{key}": ms["plain"]})
        if B == 1 and n >= 10240:
            reread = lambda: _reread_projection(kern, A, L, fixed, r, plan)
            if not torch.equal(_bits(reread()), _bits(kern.project_tangent(A, L, fixed, r))):
                raise AssertionError(f"project_tangent {shape}: the reread variant differs from the planned one")
            t = _in_turns({"staged": lambda: kern.project_tangent(A, L, fixed, r), "reread": reread})
            d = {"staged": _device_us(lambda: kern.project_tangent(A, L, fixed, r)), "reread": _device_us(reread)}
            rec["project_tangent"].update({f"device_us_{shape}_reread": d["reread"], f"ms_{shape}_reread": t["reread"]})
            print(f"project_tangent {shape} (S={plan}): second pass from shared memory {d['staged']:.2f} us, from device "
                  f"memory {d['reread']:.2f} us of device time a call (events {t['staged']:.4f} / {t['reread']:.4f} ms)")
    print(f"split form timings: {time.perf_counter() - t0:.1f} s")


def _time_extra(rec: dict, name: str, shape: tuple, bound: dict, fns: dict) -> None:
    """Time one kernel at one more shape, in turns with its plain version
    and its library call (or the call site it replaces); the record's keys
    carry the shape as a suffix."""
    t = _in_turns(fns)
    yard = "library" if "library" in fns else "old_site"
    suffix = "_" + "x".join(map(str, shape))
    rec[name].update({"ms" + suffix: t["kernel"], "plain_ms" + suffix: t["plain"], f"{yard}_ms" + suffix: t[yard],
                      "bound_us" + suffix: bound["bound_us"], "bound_by" + suffix: bound["bound_by"]})
    print(f"{name} {suffix[1:]}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, {yard.replace('_', ' ')} {t[yard]:.4f} ms, "
          f"bound {bound['bound_us']:.4f} us ({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")


# The narrow QR's timed shapes: every path's (the polishes' qr_r([JZ; D]) and
# thin_qr(Wᵀ) of configs 2, 5, 1 and 3, the multiplier estimate's thin_qr(Cᵀ),
# a float32 solve at B = 1, phase 3's one instance) and the gate's corners.
NARROW_QR_SHAPES = ((1024, 35, 3), (1024, 3, 1), (16384, 35, 3), (16384, 3, 1), (1024, 7, 3), (1024, 3, 2),
                    (512, 3, 1), (64, 192, 6), (1, 3, 1), (1, 35, 3), (4, 2048, 16), (64, 2048, 16))
# The polish's stacked [JZ; D] among them (d + n rows): configs 2 and 5 (d = 32) and config 1's sphere (d = 4).
NARROW_QR_STACKED = ((1024, 35, 3), (16384, 35, 3), (1024, 7, 3))


def _time_narrow_qr(kern, rng, rec) -> None:
    """The narrow QR at every shape of NARROW_QR_SHAPES, float32: its forms
    (`batched_thin_qr`, Q and R; `narrow_qr_r`, R only; at the polish's
    shapes `narrow_qr_r(JZ, dbot)`, the stacked form) in turns with the plain
    version and `torch.linalg.qr` (CUDA events: forms, plain, library,
    library, plain, forms; fewer calls of the plain and library), then each
    form's device µs a call (torch.profiler), beside the bounds: Q and R
    `_qr_bound`, R only `_r_bound`, stacked JZ and dbot read and R written.
    The record's main keys: batched_thin_qr at config 2's thin_qr(Wᵀ),
    1024x3x1, narrow_qr_r at config 2's polish, the stacked form at
    1024x(32+3)x3."""
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    for shape in NARROW_QR_SHAPES:
        B, D, N = shape
        A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        key = "x".join(map(str, shape))
        forms = {"qr": lambda A=A: kern.batched_thin_qr(A), "r_only": lambda A=A: kern.narrow_qr_r(A)}
        bounds = {"qr": _qr_bound(B, D, N), "r_only": _r_bound(B, D, N)}
        if shape in NARROW_QR_STACKED:
            JZ, dbot = A[:, : D - N].contiguous(), _polish_dbot(rng, B, N, dev)
            forms["stacked"] = lambda JZ=JZ, dbot=dbot: kern.narrow_qr_r(JZ, dbot)
            bounds["stacked"] = _bound(B * ((D - N) * N + N + N * N) * 4, B * (2 * D * N * N - 2 * N ** 3 / 3))
        calls = {**forms, "plain": lambda A=A: kern.batched_thin_qr_plain(A),
                 "library": lambda A=A: torch.linalg.qr(A, mode="reduced")}
        reps = {name: 200 for name in forms} | {"plain": 20, "library": 2 if B > 1024 else (5 if B > 1 else 50)}
        total = dict.fromkeys(calls, 0.0)
        for name in list(calls) + list(calls)[::-1]:
            total[name] += _cuda_ms(calls[name], reps[name], 2) / 2
        dev_us = {name: _device_us(fn, 20) for name, fn in forms.items()}
        for name in forms:
            rk, sfx = ("batched_thin_qr", "") if name == "qr" else ("narrow_qr_r", "_stacked" if name == "stacked" else "")
            b = bounds[name]
            rec[rk].update({f"ms_{key}{sfx}": total[name], f"device_us_{key}{sfx}": dev_us[name],
                            f"plain_ms_{key}": total["plain"], f"library_ms_{key}": total["library"],
                            f"bound_ms_{key}{sfx}": b["bound_ms"], f"bound_us_{key}{sfx}": b["bound_us"],
                            f"bound_by_{key}{sfx}": b["bound_by"]})
            if (key, name) in (("1024x3x1", "qr"), ("1024x35x3", "stacked")):   # the record's main keys
                rec[rk].update({"ms": total[name], "plain_ms": total["plain"], "library_ms": total["library"],
                                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "device_us": dev_us[name],
                                "shape": key + (" stacked (32+3 rows)" if name == "stacked" else "")})
        print(f"narrow QR {key} (plan {kern.narrow_qr_plan(D, N, torch.float32)}): device us a call "
              + ", ".join(f"{name} {dev_us[name]:.3f} (bound {bounds[name]['bound_us']:.4f} us, {bounds[name]['bound_by']}: "
                          f"{bounds[name]['bytes']} B)" for name in forms)
              + "; events ms a call " + ", ".join(f"{name} {t:.4f}" for name, t in total.items()))
    print(f"narrow QR timings: {time.perf_counter() - t0:.1f} s")


def _check_launched(tag: str, launches: dict, names=PATH_KERNELS, small_n: bool = True) -> None:
    """Every kernel of the path was launched in the run just made; on a
    small-n path (n <= 192: every path but config 4's) the fused kernels
    only in their warp form."""
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched on this path")
    if small_n:
        _require_no_split(kern, tag)


def _require_no_split(kern, tag: str) -> None:
    split = _split_launches(kern)
    if split:
        raise AssertionError(f"{tag}: the fused kernels ran in the split form on a small-n path: {split}")


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
    from benlsip_tpu_torch import _loops
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

    _loops.reset_host_syncs()
    t0 = time.perf_counter()
    X2, _, info2 = solve_mixed_precision(bp, theta, X0, opts)
    _sync()
    warm = time.perf_counter() - t0
    syncs = _loops.HOST_SYNCS

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
    _check_launched("config 2", launches, POLISH_KERNELS)
    _require(not any(launches[k] for k in MINOR_KERNELS), f"config 2: the minor kernels launched "
             f"{ {k: launches[k] for k in MINOR_KERNELS} } times; n = 3 has no materialized operator")
    _require(launches["batched_cho_solve"] == 0, f"config 2: batched_cho_solve launched {launches['batched_cho_solve']} "
             "times; the dual Newton, its one caller here, is the polyhedron_newton kernel")
    # A traced warm run: device kernels in all and the dual Newton's.
    kernels, newton = _traced_kernels(lambda: solve_mixed_precision(bp, theta, X0, opts), "polyhedron_newton")
    print(f"config 2 eager: host syncs per warm call {syncs} (before the dual-Newton kernel "
          f"{CONFIG2_BEFORE['host_syncs']}); a traced warm run: {kernels} device kernels (before the dual-Newton "
          f"kernel {CONFIG2_BEFORE['device_kernels']}; before the stacked narrow QR "
          f"{CONFIG2_DEVICE_KERNELS_BEFORE_STACKED:,}: {kernels - CONFIG2_DEVICE_KERNELS_BEFORE_STACKED:+d}), "
          f"{newton} of them polyhedron_newton")
    _require(syncs < 744 and kernels < 68877, "config 2 eager: host syncs and device kernels must fall below the "
             "lower ends of the counts before the dual-Newton kernel")

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
    return {"launches": launches, "cold_s": cold, "warm_s": warm, "certified": n_cert, "pix_max": pix_max,
            "host_syncs": syncs, "device_kernels": kernels}


def _traced_kernels(fn, name: str) -> tuple:
    """(device kernels, those of kernel `name`) of one call of fn traced by
    torch.profiler (`_traced_device_events`)."""
    events = _traced_device_events(fn)
    if not events:
        raise AssertionError(f"torch.profiler saw no device kernel in {TRACE_ATTEMPTS} traces")
    return (sum(e.count for e in events),
            sum(e.count for e in events if re.search(rf"\b{DEVICE_NAMES[name]}[<(]", e.key)))


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
    """Each kernel of the config-2 path (and the solve kernel, whose body
    runs inside two of them) captured alone into a CUDA graph at the path's
    shapes and replayed: the replay equals the eager call."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    A, fixed, r = _fused_case(rng, 512, 1, 3, False, dev)
    fixed[510:] = fixed[0]
    L = kern.masked_aat_cholesky(A, fixed)
    b = torch.as_tensor(rng.standard_normal((512, 1)), dtype=torch.float32, device=dev)
    S = torch.as_tensor(rng.standard_normal((1024, 35, 3)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.standard_normal((1024, 3, 1)), dtype=torch.float32, device=dev)
    JZ, dbot = S[:, :32].contiguous(), _polish_dbot(rng, 1024, 3, dev)
    poly = _newton_case(rng, 512, 1, 3, False, dev)
    calls = {
        "masked_aat_cholesky": lambda: kern.masked_aat_cholesky(A, fixed),
        "project_tangent": lambda: kern.project_tangent(A, L, fixed, r),
        "batched_cho_solve": lambda: kern.batched_cho_solve(L, b),
        # The wrapper itself: this check is not a path call for NEWTON_SEEN.
        "polyhedron_newton": lambda: _newton(getattr(kern.polyhedron_newton, "__wrapped__", kern.polyhedron_newton), *poly),
        "batched_thin_qr": lambda: kern.batched_thin_qr(S) + kern.batched_thin_qr(W),
        "narrow_qr_r": lambda: (kern.narrow_qr_r(JZ, dbot), kern.narrow_qr_r(S)),
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
    _require_no_split(kern, "fused config 2, the stages run eagerly")
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
          f"{replay['device_kernels']} device kernels and {replay['device_copies']} copies (node counts x trips; "
          f"before the dual-Newton kernel {CONFIG2_BEFORE['while_trips']} trips, {CONFIG2_BEFORE['fused_device_kernels']} "
          f"device kernels); "
          f"path kernels run by the replays {executed}, "
          f"launched by the same stages run eagerly {eager_launches}")
    for name in POLISH_KERNELS:
        _require(captured[name] > 0 and executed[name] > 0, f"fused config 2: kernel {name} captured {captured[name]}, run by the replays {executed[name]}")
    _require(all(executed[k] >= eager_launches[k] for k in POLISH_KERNELS),
             f"fused config 2: the replays ran fewer path kernels ({executed}) than the same stages eagerly ({eager_launches})")
    _require(not any(captured[k] or executed[k] for k in MINOR_KERNELS),
             f"fused config 2: the minor kernels captured { {k: captured[k] for k in MINOR_KERNELS} }, run "
             f"{ {k: executed[k] for k in MINOR_KERNELS} } times; n = 3 has no materialized operator")

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
                         for k in PATH_KERNELS}   # batched_thin_qr: both narrow QR entries
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
    _check_launched("config 3", launches, DENSE_BULK_KERNELS)
    _require(launches["minor_direction_r"] == 0, f"config 3: the minor-iteration kernel launched "
             f"{launches['minor_direction_r']} times beside the minor-loop kernel")
    kernels, newton = _traced_kernels(lambda: run("auto"), "polyhedron_newton")
    print(f"config 3: a traced warm run: {kernels} device kernels (before the dual-Newton kernel "
          f"{DEVICE_KERNELS_BEFORE_NEWTON['config 3']}), {newton} of them polyhedron_newton")

    # Host certification (f32 factors on the card, f64 chord on the CPU).
    kern.reset_launches()
    (Xh, _, info_h), host_cold = _walled(lambda: run("host"))
    launches_host = dict(kern.LAUNCHES)
    _check_launched("config 3 certify=host", launches_host, DENSE_BULK_KERNELS)
    _require(launches_host["minor_direction_r"] == 0, "config 3 certify=host: the minor-iteration kernel launched")
    print(f"config 3: blocked_qr_r launches a run: {launches['blocked_qr_r']} (certify=auto), "
          f"{launches_host['blocked_qr_r']} (certify=host); batch/polish runs a fixed budget of chord steps "
          f"(5 steps: 2 factor, 3 chord) and does not expose how many a lane needed")
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
            "host_cold_s": host_cold, "host_warm_s": host_warm, "bulk_s": bulk, "X": X, "info": info}


FUSED3_TURNS = 5


def _check_rescue_capture() -> dict:
    """CholeskyQR2 (`ops/qr.cholqr2i_r`) at config 3's operator shape with
    lane 0's implicit refinement forced to break down, eagerly (the host
    gathers lane 0 for the explicit pass) and captured into a CUDA graph
    (the pass on every lane behind an IF node, lane 0 selected): the
    healthy lanes bitwise equal, the rescued lane's difference printed, both
    within 1e-5 of SᵀS."""
    from benlsip_tpu_torch import _loops
    from benlsip_tpu_torch.ops import qr

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(11)
    S = torch.as_tensor(rng.standard_normal((8, 1030, 192)) / math.sqrt(1030), dtype=torch.float32, device=dev)
    implicit = qr._implicit_refine_r2

    def lane_0_broken(G, R1):
        R2, bad = implicit(G, R1)
        bad = bad.clone()
        bad[0] = True
        return torch.where(bad, torch.eye(G.shape[-1], dtype=G.dtype, device=G.device), R2), bad

    qr._implicit_refine_r2 = lane_0_broken
    try:
        eager = qr.cholqr2i_r(S)
        graph = torch.cuda.CUDAGraph()
        with _loops.loop_mode("capture"), torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            captured = qr.cholqr2i_r(S)
        graph.replay()
        _sync()
    finally:
        qr._implicit_refine_r2 = implicit
    Sd, G = S.double(), None
    G = Sd.mT @ Sd
    err = {name: float((torch.linalg.matrix_norm(R.double().mT @ R.double() - G) / torch.linalg.matrix_norm(G)).max())
           for name, R in (("eager", eager), ("captured", captured))}
    lane0 = float((eager[0] - captured[0]).abs().max())
    _require(torch.equal(eager[1:], captured[1:]), "rescue under capture: a healthy lane differs from the eager route")
    _require(max(err.values()) <= 1e-5, f"rescue under capture: ‖RᵀR − SᵀS‖/‖SᵀS‖ {err}")
    print(f"fused config 3: CholeskyQR2 of 8x1030x192 with lane 0's refinement forced to break down, captured (explicit "
          f"pass on every lane behind an IF node) vs eager (lane 0 gathered): healthy lanes bitwise equal, rescued lane "
          f"max |dR| {lane0:.3e} ({'bitwise equal' if lane0 == 0 else 'not bitwise equal'}), RᵀR error {err}")
    return {"rescued_lane_diff": lane0}


def phase_fused_config3(kern, smi: str, res3: dict, profile: bool) -> dict:
    """Config 3 through `solve_mixed_precision(..., fuse=True)`: the bulk
    (with the materialized CholeskyQR2 operator, its rebuilds and rescues
    behind conditional IF nodes) and the certification as CUDA-graph
    replays, cold and warm, against the unfused run of phase 5 and the same
    stages run eagerly on the card."""
    from benlsip_tpu_torch import _loops
    from benlsip_tpu_torch.batch import fused_small
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family
    from benlsip_tpu_torch.solver import subproblem
    from benlsip_tpu_torch.solver.options import SolverOptions

    t_phase = time.perf_counter()
    rescue = _check_rescue_capture()
    dev = torch.device("cuda:0")
    B, n, d, m = 64, 192, 1024, 6
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp, theta, X0 = dense_quadratic_family(B, n=n, d=d, m=m, seed=3, dtype=torch.float64, device=dev)
    fused = lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=B, fuse=True)
    plain = lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=B)

    kern.reset_launches()
    fused_small.reset_graph_stats()
    subproblem.reset_operator_builds()
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
    _check_certified("fused config 3 cold", X, info, B, n)
    _check_certified("fused config 3 warm", X2, info2, B, n)
    _require(torch.equal(X2, X) and torch.equal(info2.converged, info.converged), "fused config 3: the warm run differs from the cold run")
    refined = int((info2.outer_iters > 0).sum())
    _require(refined > 0 or not any(launches.values()),
             f"fused config 3: a warm call with no fallback lane launched kernels outside its graphs: {launches}")
    capture_s = sum(s["capture_s"] for s in stats)
    instantiate_s = sum(s["instantiate_s"] for s in stats)
    for s in stats:
        print(f"fused config 3 graph {s['stage']}: capture {s['capture_s']:.3f} s, instantiate {s['instantiate_s']:.3f} s, "
              f"{s['loops']} WHILE nodes, {s['branches']} IF nodes, {s['kernel_nodes']} kernel nodes, "
              f"captured launches {s['captured_launches']}")
    _require(any(s["branches"] > 0 for s in stats), "fused config 3: no IF node was captured")
    print(f"fused config 3, B={B}: certified {int(info.converged.sum())}/{B}, max pix {float(info.pix.max()):.3e}, cold {cold:.3f} s "
          f"({len(stats)} graphs, capture {capture_s:.3f} s, instantiate {instantiate_s:.3f} s, {cold_syncs} host syncs), "
          f"first warm {warm0:.3f} s, lanes sent to the fallback refine {refined}, kernels launched outside the graphs "
          f"in the warm call {launches} on {smi}")

    # Against the unfused run (phase 5) and the same stages run eagerly.
    Xu = res3["X"]
    du = float((X - Xu).abs().max())
    _require(torch.equal(res3["info"].converged, info.converged) and torch.allclose(X, Xu, rtol=FUSED_RTOL, atol=FUSED_ATOL),
             f"fused config 3: disagrees with the unfused run (max |dX| {du:.3e})")
    with _stages_eagerly():
        fused()
        kern.reset_launches()
        subproblem.reset_operator_builds()
        _loops.reset_host_syncs()
        (Xe, _, ie), eager_wall = _walled(fused)
    syncs["fused_eager"] = _loops.HOST_SYNCS
    eager_launches, eager_builds = dict(kern.LAUNCHES), dict(subproblem.OPERATOR_BUILDS)
    _require_no_split(kern, "fused config 3, the stages run eagerly")
    de = float((X - Xe).abs().max())
    _require(torch.equal(ie.converged, info.converged) and torch.allclose(X, Xe, rtol=FUSED_RTOL, atol=FUSED_ATOL),
             f"fused config 3: the graphs disagree with the same stages run eagerly (max |dX| {de:.3e})")
    _loops.reset_host_syncs()
    plain()
    syncs["unfused"] = _loops.HOST_SYNCS
    print(f"fused config 3: max |dX| captured vs unfused {du:.3e} (rtol {FUSED_RTOL:g}, atol {FUSED_ATOL:g}), captured vs the "
          f"same stages run eagerly {de:.3e} ({'identical' if de == 0 else 'not identical'}; eager fused wall {eager_wall:.3f} s)")
    print(f"fused config 3: host syncs per warm call: unfused {syncs['unfused']}, fused as graphs {syncs['fused']}, "
          f"fused stages run eagerly {syncs['fused_eager']}")
    builds = {f"{f}/{dt}": v for (f, dt), v in replay["operator_builds"].items()}
    print(f"fused config 3: a warm call's {replay['replays']} graph replays ran {replay['loop_trips']} WHILE-node trips, "
          f"took {replay['branches_taken']} IF-node branches, {replay['device_kernels']} device kernels and "
          f"{replay['device_copies']} copies (node counts x runs); operator builds run by the replays (the events noted "
          f"in the captured parts times their runs) {builds}, by the same stages run eagerly (OPERATOR_BUILDS) "
          f"{ {f'{f}/{dt}': v for (f, dt), v in eager_builds.items()} }")
    _require(list(builds) == ["cholqr2/float32"] and builds["cholqr2/float32"] > 0,
             f"fused config 3: the replays must build the CholeskyQR2 operator only, built {builds}")
    print(f"fused config 3: path kernels run by the replays {executed}, launched by the same stages run eagerly {eager_launches}")
    for name in DENSE_BULK_KERNELS:
        _require(captured[name] > 0 and executed[name] > 0,
                 f"fused config 3: kernel {name} captured {captured[name]}, run by the replays {executed[name]}")
    _require(captured["minor_direction_r"] == executed["minor_direction_r"] == 0,
             f"fused config 3: the minor-iteration kernel captured {captured['minor_direction_r']}, run "
             f"{executed['minor_direction_r']} times beside the minor-loop kernel")

    # The oracle on all 64.
    fns = bp.instance_fns(theta)
    r = fns.residuals(X).cpu().numpy()
    J = fns.jac_res(X)[0].cpu().numpy()
    Xn, A, b_rhs = X.cpu().numpy(), bp.A.cpu().numpy(), bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    agree = _oracle_agreement("fused config 3", [(Xn[i], r[i], J, None, None, A, b_rhs, xl, xu) for i in range(B)])
    _require(agree == B, f"fused config 3: oracle agrees on {agree}/{B}")

    # Warm walls in turns: unfused, fused, fused, unfused, ...
    walls = {"fused": [], "unfused": []}
    for i in range(FUSED3_TURNS):
        for name in (("unfused", "fused") if i % 2 == 0 else ("fused", "unfused")):
            walls[name].append(_walled(fused if name == "fused" else plain)[1])
    for name, w in walls.items():
        print(f"fused config 3: warm wall {name} ({FUSED3_TURNS} calls in turns) median {float(np.median(w)):.4f} s, "
              f"range {min(w):.4f}-{max(w):.4f} s, all {[round(x, 4) for x in w]} on {smi}")
    res = {"cold_s": cold, "warm_s": walls, "syncs": syncs, "captured": captured, "executed": executed,
           "device_kernels": replay["device_kernels"], "capture_s": capture_s, "instantiate_s": instantiate_s,
           "builds": builds, "eager_builds": eager_builds, "branches_taken": replay["branches_taken"], **rescue}
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = _walled(plain)[1]
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in events) / 1e6
        print(f"profile fused config 3: one traced warm unfused call, wall {traced:.4f} s, device time {dev_s:.4f} s "
              f"(busy {100 * dev_s / traced:.1f}%), {sum(e.count for e in events)} device kernels; fused warm wall "
              f"median {float(np.median(walls['fused'])):.4f} s on {smi}")
        res["unfused_busy_share"] = dev_s / traced
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"fused config 3 phase: {res['phase_s']:.1f} s")
    return res



def _bulk_split(calls: int) -> list:
    """The device operations of the cached pipelines' replays since the
    last `reset_replay_counts()`, part by part of each stage's graph — its
    top level and each captured WHILE or IF body — ÷ `calls`: the part's
    launches by name (one run or trip, nested parts apart), its kernel and
    copy nodes, its runs (replays, trips or taken branches) a call, and
    their product, the part's share of `device_ops_per_call`."""
    from benlsip_tpu_torch.batch import fused_small

    rows = []
    for pipe in fused_small._PIPELINES.values():
        for stage in [b.stage for b in pipe.bulks.values()] + [pipe.cert]:
            if stage.graph is None:
                continue
            runs = [stage.replays] + stage.trips.tolist()
            for i, ((launches, k, c), n_runs) in enumerate(zip(stage.parts, runs)):
                rows.append({"stage": stage.name, "part": i, "kind": "top" if i == 0 else stage.kinds[i - 1],
                             "launches": {str(key): v for key, v in launches.items() if v},
                             "kernel_nodes": k, "copy_nodes": c, "runs_per_call": n_runs / calls,
                             "ops_per_call": (k + c) * n_runs / calls})
    return rows


def phase_bulk_split(cell: str = "densequad-b64-fused", calls: int = 64, seed: int = 1) -> dict:
    """`device_ops_per_call` of the benchmark cell `cell` split part by part
    (`_bulk_split`): its pool (portbench's family, the cell's configuration
    and traffic, `seed`), one call to capture, then `calls` calls over the
    pool with the replays counted.  Outside every timed path.  Runs on any
    checkout of the port that has the fused pipeline and the cell's family
    (the parent's too: `sys.path` first to its root); the minor-iteration
    kernels' launches a call are printed with the trips of the loops that
    launch them."""
    from benlsip_tpu_torch.batch import fused_small
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision

    _, mix, pool, opts = _cell_pool(cell, seed, torch.device("cuda:0"))

    def call(k: int):
        bp, theta, X0 = pool.batch(k % pool.size)
        return solve_mixed_precision(bp, theta, X0, opts, **mix["route"])

    call(0)
    _sync()
    fused_small.reset_replay_counts()
    for k in range(calls):
        call(k)
    _sync()
    replay = fused_small.replay_counts()
    rows = _bulk_split(calls)
    total = sum(r["ops_per_call"] for r in rows)
    by_stage = collections.Counter()
    for r in rows:
        by_stage[r["stage"]] += r["ops_per_call"]
    print(f"bulk split over {calls} calls of {cell} (seed {seed}): device ops a call {total:.1f} "
          f"(replay_counts: {(replay['device_kernels'] + replay['device_copies']) / calls:.1f}), by stage "
          f"{ {k: round(v, 1) for k, v in by_stage.items()} }, WHILE trips a call {replay['loop_trips'] / calls:.2f}")
    for r in sorted(rows, key=lambda r: -r["ops_per_call"]):
        if r["ops_per_call"] >= 1:
            print(f"bulk split: {r['stage']} part {r['part']:3d} {r['kind']:5s} {r['ops_per_call']:9.1f} ops a call = "
                  f"({r['kernel_nodes']} kernel + {r['copy_nodes']} copy nodes) x {r['runs_per_call']:.3f} runs; "
                  f"launches a run {r['launches']}")
    out = {"cell": cell, "rows": rows, "ops_per_call": total, "while_trips_per_call": replay["loop_trips"] / calls}
    for name in ("minor_direction_r", "minor_loop_r"):
        per_call = replay["launches"].get(name, 0) / calls
        trips = sum(r["runs_per_call"] * r["launches"].get(name, 0) for r in rows)
        print(f"bulk split: {name} launches a call {per_call:.3f}, the runs of the parts that launch it a call {trips:.3f}")
        _require(abs(per_call - trips) < 1e-9, f"bulk split: {name}'s launches are not the runs of its parts")
        out[f"{name}_launches_per_call"] = per_call
    return out


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
        first = ""
        if mode == "fused":
            counts = fused_small.replay_counts()
            launches = {k: v + kern.LAUNCHES[k] for k, v in counts["launches"].items()}
            first = f" (the first round {B - counts['polish_stragglers']}/{B})"
        ok = info.converged
        n_cert = int(ok.sum())
        tag = f"config 1 sphere_family B={B} {'fuse=True' if mode == 'fused' else 'certify=' + mode}"
        print(f"{tag}: certified {n_cert}/{B}, by the polish {_polished_lanes(info)}/{B}{first}, "
              f"max pix {float(info.pix[ok].max()):.3e}, max feas {float(info.feas[ok].max()):.3e}, "
              f"cold {cold:.3f} s, warm {warm:.3f} s on {smi}, launches {launches}")
        _require(X.shape == (B, 3) and Y.shape == (B, 1) and X.dtype == torch.float64 and bool(torch.isfinite(X[ok]).all()),
                 f"{tag}: X (B, 3) and Y (B, 1) must be finite float64")
        _require(X.device.type == ("cpu" if mode == "host" else "cuda"), f"{tag}: results on the wrong device")
        _require(n_cert >= 0.9 * B, f"{tag}: only {n_cert}/{B} certified")
        _require(float(info.pix[ok].max()) <= CERT_PIX and float(info.feas[ok].max()) <= CERT_PIX, f"{tag}: a certified lane misses 1.49e-8")
        _require(torch.equal(info2.converged, ok) and float((X2 - X)[ok].abs().max()) <= SMALL_ATOL, f"{tag}: the warm run disagrees with the cold run")
        # certify="host" polishes in float64 on the CPU: no polish kernel there.
        _check_launched(tag, launches, PATH_KERNELS if mode == "host" else POLISH_KERNELS)
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
CONFIG4_KERNELS = ("masked_aat_cholesky", "project_tangent", "polyhedron_newton")
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


def phase_config4(kern) -> dict:
    """Config 4 at full size through `dist/sharded.solve_large_blocked_family`
    on a one-rank NCCL mesh: one cold call, two warm calls, the gates of the
    JAX package's bench (converged, the oracle at f32 grade), the operator
    builds and kernel launches of the cold run (the fused kernels in their
    split form), peak device memory; two warm calls with the fused kernels
    in their warp form in turns with the warm calls; one traced warm call
    (busy share, the Gram GEMM and the fused kernels' share of device time);
    then the explicit-collective path against it at a reduced size, and
    the card against the port's CPU run at n = 1024."""
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
    by_plan = {f"{name} S={S}": k for (name, S), k in kern.LAUNCHES_BY_PLAN.items()}
    builds = {f"{fact}/{dt}": k for (fact, dt), k in subproblem.OPERATOR_BUILDS.items()}
    peak = torch.cuda.max_memory_allocated()
    # Warm walls of the split form (the plan) and of the warp form (the plan
    # swapped for 1 by this script), two each, in turns: split, warp, warp, split.
    plan = kern.fused_plan(CONFIG4["m"], n, torch.float32)
    warm, warm_warp = [], []
    for form in ("split", "warp", "warp", "split"):
        with _forced_plan(kern, 1) if form == "warp" else contextlib.nullcontext():
            (xw, _, iw), wall = _walled(run)
        if form == "split":
            x2, info2 = xw, iw
            warm.append(wall)
        else:
            warm_warp.append(wall)
            print(f"config 4 warm, warp form: {_info_line(iw)}, {wall:.3f} s")
    inner = int(info.inner_iters)
    warm_diff = float((x2 - x).abs().max())
    active = float(((x - bp.xl < 1e-6) | (bp.xu - x < 1e-6)).float().mean())
    print(f"config 4 (n={n}, d={d}, m={CONFIG4['m']}, f32, one-rank NCCL mesh): {_info_line(info)}, "
          f"active fraction {active:.3f}")
    print(f"config 4: data {data_s:.2f} s, cold {cold:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"warm s per inner iteration {min(warm) / max(inner, 1):.4f}, peak device memory {peak / 2**30:.2f} GiB, "
          f"max |dx| warm vs cold {warm_diff:.3e}")
    print(f"config 4: warm walls in turns (split, warp, warp, split): split form (plan {plan}) "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, warp form {', '.join(f'{w:.3f}' for w in warm_warp)} s")
    print(f"config 4: operator builds in the cold run (factorization/dtype: count) = {builds}")
    print(f"config 4: kernel launches in the cold run {launches}, the fused kernels by plan {by_plan}")
    _require(x.shape == (n,) and x.dtype == torch.float32 and bool(torch.isfinite(x).all()),
             "config 4: x must be finite float32 of shape (n,)")
    _require(bool(info.converged), "config 4: the solve must converge")
    _require(list(builds) == ["normal/float32"] and builds["normal/float32"] > 0,
             f"config 4: the operator must be the Gram matrix in float32 only, built {builds}")
    _check_launched("config 4", launches, CONFIG4_KERNELS, small_n=False)
    _require(not any(launches[k] for k in MINOR_KERNELS), f"config 4: the minor kernels launched "
             f"{ {k: launches[k] for k in MINOR_KERNELS} } times on the Gram operator")
    for name in ("masked_aat_cholesky", "project_tangent", "polyhedron_newton"):
        _require(plan > 1 and by_plan.get(f"{name} S={plan}", 0) > 0,
                 f"config 4: {name} did not run in the split form (plan {plan}): {by_plan}")
    _require(bool(info2.converged) and warm_diff <= SMALL_ATOL,
             "config 4: a warm run disagrees with the cold run")
    verdict = _config4_oracle("config 4", bp, theta, x, alpha)
    _require(bool(verdict["ok"]), "config 4: the KKT oracle rejects the point")

    res = {"launches": launches, "by_plan": by_plan, "cold_s": cold, "warm_s": warm, "warm_warp_s": warm_warp,
           "inner": inner, "peak_bytes": peak, "data_s": data_s}
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
    """One traced warm config-4 run: device busy share, device kernels, the
    Gram GEMM (the largest kernel) and the two fused kernels by name (the
    split form's CUDA functions are `*_split_kernel`)."""
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
    fused = {}
    for kernel in ("masked_aat_cholesky_split_kernel", "masked_aat_cholesky_kernel", "project_tangent_split_kernel",
                   "project_tangent_kernel"):
        mine = [e for e in events if kernel + "<" in e.key]
        us = sum(e.self_device_time_total for e in mine)
        fused[kernel] = us / 1e6
        print(f"profile config 4: {kernel} {us / 1e3:.3f} ms over {sum(e.count for e in mine)} calls, "
              f"{100 * us / max(dev_us, 1):.2f}% of device time")
    share = 100 * sum(fused.values()) * 1e6 / max(dev_us, 1)
    print(f"profile config 4: the two fused kernels {sum(fused.values()) * 1e3:.3f} ms, {share:.2f}% of device time")
    return {"traced_wall_s": wall, "device_busy_s": dev_us / 1e6, "gemm_s": gemm_us / 1e6, "fused_s": fused,
            "fused_share_pct": share}


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

    from benlsip_tpu_torch import _loops, _trace
    from benlsip_tpu_torch.baselines.numpy_ref import solve_exp_fit_numpy
    from benlsip_tpu_torch.batch import compact, fused_small
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
    _check_launched("config 5", launches["plain"], POLISH_KERNELS)
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
    _check_launched("config 5 compact", launches["compact"], POLISH_KERNELS)
    for k in POLISH_KERNELS:
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
        # The overlapped route's stages are its spans: the recorder is on for
        # that call alone.
        if "overlap" in name:
            _trace.enable()
            _trace.reset()
        (Xo, _, io), wall = _walled(lambda: solve_mixed_precision(bp_b, th_b, X0_b, opts, **kw))
        _check_certified(f"config 5 {name}", Xo, io, Bb, 3)
        d = float((Xo.to(dev) - Xb).abs().max())
        line = (f"config 5 {name} (B={Bb}): certified {int(io.converged.sum())}/{Bb}, wall {wall:.3f} s beside the plain "
                f"route's {plain_b:.3f} s, max |dX| against it {d:.3e}")
        if "overlap" in name:
            spans = _trace.spans()
            _trace.disable()
            seconds = lambda stage: sum(s.t1 - s.t0 for s in spans if s.name == stage) / 1e9
            st = {"wall_s": seconds("call"), "bulk_s": seconds("bulk"), "certify_s": seconds("certify")}
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


# ---------------------------------------------------------------------------
# Phase 9: the reduced-precision bulk (bf16 kernels, bulk_dtype=bf16, TF32)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
SMALL_KERNELS = ("batched_cholesky", "batched_cho_solve", "batched_thin_qr", "narrow_qr_r", "masked_aat_cholesky",
                 "project_tangent")
# The bf16 paths: config 2 and config 3 run the fused kernels and the dual
# Newton in bf16; only sphere_family (p = 1) runs the QR kernel in its bulk
# (the multiplier estimate's thin_qr(Cᵀ)).
BF16_PATH_KERNELS = ("masked_aat_cholesky", "project_tangent", "polyhedron_newton")
# The bulk's X against the float32 bulk's, both certified: the JAX package's
# own bar for a bf16 bulk (tests/test_refine.py).
BF16_RTOL, BF16_ATOL = 1e-7, 1e-8
BF16_TURNS = 5


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |x| (8 significant bits), x float32."""
    x = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _check_bf16(name: str, got: torch.Tensor, want: torch.Tensor, atol32: float) -> tuple:
    """A bf16 kernel against its plain version (the float32 plain version on
    the upcast inputs, rounded once): NaN patterns equal, and every entry
    within one bf16 ulp of the plain value plus the float32 kernel's own
    slack `atol32` (sums taken in another order before the one rounding).
    Returns (max abs err, max err in bf16 ulps, bitwise equal)."""
    if got.dtype != BF16 or got.shape != want.shape:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, want bf16 {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{name}: NaN pattern differs from the plain version's")
    ok = ~torch.isnan(w)
    d, ulp = (g - w).abs()[ok], _bf16_ulp(w[ok])
    if d.numel() and not bool((d <= ulp + atol32).all()):
        raise AssertionError(f"{name}: bf16 kernel off its plain version by {float((d / ulp).max()):.2f} ulps "
                             f"(max abs err {float(d.max()):.3e}, slack one ulp + {atol32:.2e})")
    if not d.numel():
        return 0.0, 0.0, True
    return float(d.max()), float((d / ulp).max()), bool(torch.equal(got[ok], want[ok]))


def _bf16_kernel_checks(kern) -> dict:
    """Phase 3's checks of the five small kernels in bf16, at every bf16
    path's shape and the kernel tests' shapes."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(9)
    rec = {k: {"max_abs_err_bf16": 0.0, "max_ulps_bf16": 0.0, "bitwise_bf16": True} for k in SMALL_KERNELS}

    def worst(name, res):
        err, ulps, same = res
        r = rec[name]
        r["max_abs_err_bf16"], r["max_ulps_bf16"] = max(r["max_abs_err_bf16"], err), max(r["max_ulps_bf16"], ulps)
        r["bitwise_bf16"] &= same

    def spd(B, M):
        A = rng.standard_normal((B, M, M))
        return torch.as_tensor(A @ np.transpose(A, (0, 2, 1)) + M * np.eye(M), dtype=BF16, device=dev)

    for B, M in ((512, 1), (64, 6), (1024, 3), (1024, 16), (1, 1), (1, 6), (1, 16)):
        K = spd(B, M)
        L = kern.batched_cholesky(K)
        worst("batched_cholesky", _check_bf16(f"cholesky bf16 {B}x{M}x{M}", L, kern.batched_cholesky_plain(K), 0.0))
        b = torch.as_tensor(rng.standard_normal((B, M)), dtype=BF16, device=dev)
        worst("batched_cho_solve", _check_bf16(f"cho_solve bf16 {B}x{M}", kern.batched_cho_solve(L, b),
                                               kern.batched_cho_solve_plain(L, b), 0.0))
    K = spd(1024, 3)
    K[5, 2, 2] = -50.0
    L = kern.batched_cholesky(K).float()
    if not (torch.isnan(L[5, 2, 2]) and torch.isfinite(L[torch.arange(1024, device=dev) != 5]).all()):
        raise AssertionError("cholesky bf16: a non-SPD pivot must give NaN in its own instance only")

    for B, D, N in ((512, 3, 1), (1024, 35, 3), (64, 192, 6), (1024, 7, 3), (1024, 3, 2), (1, 3, 1), (1, 35, 3)):
        A = torch.as_tensor(rng.standard_normal((B, D, N)), dtype=BF16, device=dev)
        Q, R = kern.batched_thin_qr(A)
        Qp, Rp = kern.batched_thin_qr_plain(A)
        worst("batched_thin_qr", _check_bf16(f"qr bf16 Q {B}x{D}x{N}", Q, Qp, KERNEL_ATOL))
        worst("batched_thin_qr", _check_bf16(f"qr bf16 R {B}x{D}x{N}", R, Rp, KERNEL_ATOL * math.sqrt(D)))
        if not (torch.diagonal(R.float(), dim1=1, dim2=2) > 0).all() or torch.tril(R.float(), -1).abs().max() != 0:
            raise AssertionError("qr bf16: R must be upper triangular with a positive diagonal")
        # The R-only and stacked forms: R of the same (stacked) matrix, bit for bit.
        worst("narrow_qr_r", _check_bf16(f"narrow_qr_r bf16 {B}x{D}x{N}", kern.narrow_qr_r(A), Rp, KERNEL_ATOL * math.sqrt(D)))
        _require(torch.equal(_bits(kern.narrow_qr_r(A)), _bits(R)), f"narrow_qr_r bf16 {B}x{D}x{N}: R only differs from the full R")
        if D > N:
            JZ, dbot = A[:, : D - N].contiguous(), _polish_dbot(rng, B, N, dev, BF16)
            Rs = kern.narrow_qr_r(JZ, dbot)
            worst("narrow_qr_r", _check_bf16(f"narrow_qr_r bf16 stacked {B}x{D}x{N}", Rs, kern.narrow_qr_r_plain(JZ, dbot),
                                             KERNEL_ATOL * math.sqrt(D)))
            _require(torch.equal(_bits(Rs), _bits(kern.batched_thin_qr(_stack(JZ, dbot))[1])),
                     f"narrow_qr_r bf16 stacked {B}x{D}x{N}: not bitwise the R of the stacked matrix")

    cases = [(512, 1, 3, False), (64, 6, 192, True), (64, 6, 192, False), (130, 3, 37, False), (130, 16, 200, True)]
    for B, m, n, shared in cases + [(1, 1, 3, False), (1, 6, 192, False), (2, 2, 5, False)]:
        if B <= 2:   # one instance, and the degenerate pair alone
            A, fixed, r = (t[:1].contiguous() if B == 1 else t[1:].contiguous() for t in _fused_case(rng, 3, m, n, False, dev))
        else:
            A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        # The degenerate lanes' ±1, ±2 are exact in bf16; a shared A stays a stride-0 view.
        A = A[:1].to(BF16).expand(A.shape) if shared else A.to(BF16)
        r = r.to(BF16)
        tag = f"{B}x{m}x{n}{' shared' if shared else ''} bf16"
        atol_f = KERNEL_ATOL * math.sqrt(n) * float(torch.linalg.vector_norm(A.float(), dim=-1).max())
        for reg in (0.0, 1e-3):
            worst("masked_aat_cholesky", _check_bf16(f"masked_aat_cholesky {tag} reg={reg}", kern.masked_aat_cholesky(A, fixed, reg),
                                                     kern.masked_aat_cholesky_plain(A, fixed, reg), atol_f))
        L = kern.masked_aat_cholesky(A, fixed, 1e-3 if B <= 2 else 0.0)
        atol_p = KERNEL_ATOL * math.sqrt(n) * float(r.float().abs().max())
        for unmasked in (False, True):
            worst("project_tangent", _check_bf16(f"project_tangent {tag} unmasked={unmasked}",
                                                 kern.project_tangent(A, L, fixed, r, unmasked_output=unmasked),
                                                 kern.project_tangent_plain(A, L, fixed, r, unmasked_output=unmasked), atol_p))
        if B > 2 and m >= 3 and not (torch.isnan(L[B - 2, 2, 1]) and torch.isfinite(L[: B - 2].float()).all()):
            raise AssertionError(f"masked_aat_cholesky {tag}: NaN must stay in the degenerate lanes")

    # Refused operands: mixed dtypes, bf16 in the panel QR kernel, a
    # non-contiguous bf16 operand; an empty bf16 batch launches nothing.
    A, fixed, r = _fused_case(rng, 8, 3, 10, False, dev)
    Ab = A.to(BF16)
    Lb = kern.masked_aat_cholesky(Ab, fixed)
    before = dict(kern.LAUNCHES_BY_DTYPE)
    refused = (
        (ValueError, lambda: kern.project_tangent(Ab, Lb, fixed, r)),
        (ValueError, lambda: kern.batched_cho_solve(Lb, r[:, :3].contiguous())),
        (TypeError, lambda: kern.blocked_qr_r(torch.zeros((8, 64, 32), dtype=BF16, device=dev))),
        (ValueError, lambda: kern.batched_cholesky(spd(8, 3).transpose(1, 2))),
    )
    for i, (exc, call) in enumerate(refused):
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"bf16: refused operand {i} was accepted")
    shapes = (kern.batched_cholesky(torch.zeros((0, 3, 3), dtype=BF16, device=dev)).shape,
              kern.batched_thin_qr(torch.zeros((0, 35, 3), dtype=BF16, device=dev))[1].shape)
    if shapes != ((0, 3, 3), (0, 3, 3)) or dict(kern.LAUNCHES_BY_DTYPE) != before:
        raise AssertionError(f"bf16 empty batches: shapes {shapes}, launches {dict(kern.LAUNCHES_BY_DTYPE)} vs {before}")
    _sync()
    for name in SMALL_KERNELS:
        r = rec[name]
        print(f"{name} bf16: max abs err {r['max_abs_err_bf16']:.3e} = {r['max_ulps_bf16']:.3f} bf16 ulps over every "
              f"checked shape, bitwise equal to its plain version: {r['bitwise_bf16']}")
    return rec


def _bf16_times(kern, rec: dict) -> None:
    """Each small kernel at the bf16 paths' shapes, taken in turns: the
    bf16 kernel, the float32 kernel on the same values, the bf16 plain
    version and the library round trip (float32 library call, rounded to
    bf16), and back.  The bound counts bf16 bytes (the mask 1 byte)."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(10)
    for B, m, n, shared in ((512, 1, 3, False), (64, 6, 192, True)):
        A, fixed, r = _fused_case(rng, B, m, n, shared, dev)
        fixed[B - 2:] = fixed[0]
        if shared:
            A = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=dev).expand(B, m, n)
        Ab, rb = A.to(BF16), r.to(BF16)
        if shared:
            Ab = Ab[:1].expand(B, m, n)
        A32, r32 = Ab.float(), rb.float()
        if shared:
            A32 = A32[:1].expand(B, m, n)
        Lb = kern.masked_aat_cholesky(Ab, fixed)
        L32 = Lb.float()
        Kb = (L32 @ L32.mT).to(BF16).contiguous()
        K32 = Kb.float()
        bb = torch.as_tensor(rng.standard_normal((B, m)), dtype=BF16, device=dev)
        b32 = bb.float()
        free = ~fixed
        n_free = int(free.sum())
        a_bytes = (1 if shared else B) * m * n * 2
        shape = f"{B}x{m}x{n}"

        def lib_factor():
            K = (A32 * free.to(torch.float32).unsqueeze(-2)) @ A32.mT
            return torch.linalg.cholesky_ex(K)[0].to(BF16)

        def lib_project():
            rz = torch.where(free, r32, 0.0)
            w = torch.cholesky_solve((A32 @ rz.unsqueeze(-1)), L32).squeeze(-1)
            return (rz - torch.where(free, (A32.mT @ w.unsqueeze(-1)).squeeze(-1), 0.0)).to(BF16)

        cases = {
            "masked_aat_cholesky": (shape, dict(
                kernel_bf16=lambda: kern.masked_aat_cholesky(Ab, fixed), kernel_f32=lambda: kern.masked_aat_cholesky(A32, fixed),
                plain=lambda: kern.masked_aat_cholesky_plain(Ab, fixed), library=lib_factor),
                _bound(a_bytes + B * n + B * m * m * 2, m * (m + 1) * n_free + B * m ** 3 / 3)),
            "project_tangent": (shape, dict(
                kernel_bf16=lambda: kern.project_tangent(Ab, Lb, fixed, rb), kernel_f32=lambda: kern.project_tangent(A32, L32, fixed, r32),
                plain=lambda: kern.project_tangent_plain(Ab, Lb, fixed, rb), library=lib_project),
                _bound(a_bytes + B * m * m * 2 + B * n + 2 * B * n * 2, 4 * m * n_free + 2 * B * m * m)),
            "batched_cholesky": (f"{B}x{m}x{m}", dict(
                kernel_bf16=lambda: kern.batched_cholesky(Kb), kernel_f32=lambda: kern.batched_cholesky(K32),
                plain=lambda: kern.batched_cholesky_plain(Kb), library=lambda: torch.linalg.cholesky_ex(K32)[0].to(BF16)),
                _bound(2 * B * m * m * 2, B * m ** 3 / 3)),
            "batched_cho_solve": (f"{B}x{m}", dict(
                kernel_bf16=lambda: kern.batched_cho_solve(Lb, bb), kernel_f32=lambda: kern.batched_cho_solve(L32, b32),
                plain=lambda: kern.batched_cho_solve_plain(Lb, bb),
                library=lambda: torch.cholesky_solve(b32.unsqueeze(-1), L32).squeeze(-1).to(BF16)),
                _bound(B * (m * m + 2 * m) * 2, 2 * B * m * m)),
        }
        for name, (tag, fns, bound) in cases.items():
            _record_bf16_time(rec, name, tag, fns, bound)
    for shape in ((512, 3, 1), (1024, 35, 3)):
        Wb = torch.as_tensor(rng.standard_normal(shape), dtype=BF16, device=dev)
        W32 = Wb.float()
        B, D, N = shape
        key = "x".join(map(str, shape))
        _record_bf16_time(rec, "batched_thin_qr", key, dict(
            kernel_bf16=lambda: kern.batched_thin_qr(Wb), kernel_f32=lambda: kern.batched_thin_qr(W32),
            plain=lambda: kern.batched_thin_qr_plain(Wb),
            library=lambda: tuple(t.to(BF16) for t in torch.linalg.qr(W32, mode="reduced"))),
            _bound(B * (2 * D * N + N * N) * 2, 2 * B * D * N * N))
        JZ, dbot = Wb[:, : D - N].contiguous(), _polish_dbot(rng, B, N, dev, BF16)
        _record_bf16_time(rec, "narrow_qr_r", key + "_stacked", dict(
            kernel_bf16=lambda: kern.narrow_qr_r(JZ, dbot), kernel_f32=lambda: kern.narrow_qr_r(JZ.float(), dbot.float()),
            plain=lambda: kern.narrow_qr_r_plain(JZ, dbot),
            library=lambda: torch.linalg.qr(_stack(JZ, dbot).float(), mode="r")[1].to(BF16)),
            _bound(B * ((D - N) * N + N + N * N) * 2, B * (2 * D * N * N - 2 * N ** 3 / 3)))
        us = {"qr": _device_us(lambda: kern.batched_thin_qr(Wb), 20), "stacked": _device_us(lambda: kern.narrow_qr_r(JZ, dbot), 20)}
        rec["batched_thin_qr"][f"device_us_bf16_{key}"] = us["qr"]
        rec["narrow_qr_r"][f"device_us_bf16_{key}_stacked"] = us["stacked"]
        print(f"narrow QR bf16 {key}: device us a call batched_thin_qr {us['qr']:.3f}, narrow_qr_r stacked {us['stacked']:.3f}")


def _record_bf16_time(rec: dict, name: str, shape: str, fns: dict, bound: dict) -> None:
    t = _in_turns(fns)
    suffix = f"_bf16_{shape}"
    rec[name].update({"ms" + suffix: t["kernel_bf16"], "f32_kernel_ms" + suffix: t["kernel_f32"],
                      "plain_ms" + suffix: t["plain"], "library_ms" + suffix: t["library"],
                      "bound_ms" + suffix: bound["bound_ms"], "bound_by" + suffix: bound["bound_by"]})
    print(f"{name} bf16 {shape}: kernel {t['kernel_bf16']:.4f} ms, float32 kernel {t['kernel_f32']:.4f} ms, "
          f"plain {t['plain']:.4f} ms, library round trip {t['library']:.4f} ms, bound {bound['bound_us']:.4f} us "
          f"({bound['bound_by']}: {bound['bytes']} B, {bound['flops']} flop)")


def _bf16_launches(kern) -> dict:
    """The bf16 launches of each small kernel and of the dual Newton since the last reset."""
    return {name: kern.LAUNCHES_BY_DTYPE[name, "bfloat16"] for name in SMALL_KERNELS + ("polyhedron_newton",)}


def _first_polish(bp, theta, X0, opts, chunk: int, bulk_inner: int, bulk_dtype) -> int:
    """Lanes the first fused polish (rounds = 1) certifies from the bulk's
    point, the bulk run alone as the pipeline runs it."""
    from benlsip_tpu_torch.batch.polish import sqp_polish_fused
    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.solver.options import SolverOptions

    dev = X0.device
    bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(theta, torch.float32)
    bulk_opts = SolverOptions(max_outer_iter=opts.max_outer_iter, max_inner_iter=min(bulk_inner, opts.max_inner_iter),
                              crit_tol=1e-2)
    Xb = solve_batched_chunked(_cast_problem(bp32, bulk_dtype, dev), _cast_tree(th32, bulk_dtype),
                               X0.to(torch.float32).to(bulk_dtype), bulk_opts, chunk=chunk)[0].float()
    bp64, th64 = _cast_problem(bp, torch.float64, dev), _cast_tree(theta, torch.float64)
    return int(sqp_polish_fused(bp32, th32, Xb, bp64, th64, opts, num_steps=5, rounds=1)[2].sum())


def _fallback_lanes(info) -> int:
    """Lanes the pipeline sent to the full f64 refine: a polished lane
    reports no outer iteration."""
    return int((info.outer_iters > 0).sum())


def _polished_lanes(info) -> int:
    """Lanes the polish certified, its re-polish passes included."""
    return int((info.converged & (info.outer_iters == 0)).sum())


def phase_bf16(kern, smi: str) -> dict:
    """The reduced-precision bulk: the five small kernels in bf16 against
    their plain versions and timed in turns, then `bulk_dtype=torch.bfloat16`
    on config 2 (cold, warm, oracle, against the float32 bulk, walls in
    turns, compaction), `sphere_family(1024)` with `certify="host"`, config 3
    in bf16, and config 3 with `bulk_matmul_precision="default"` (TF32)."""
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family, exp_fit_family, sphere_family
    from benlsip_tpu_torch.solver import subproblem
    from benlsip_tpu_torch.solver.options import SolverOptions

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    rec = _bf16_kernel_checks(kern)
    _bf16_times(kern, rec)
    out = {"rec": rec}

    # Config 2 with a bf16 bulk.
    B = 1024
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=torch.float64, device=dev)
    run = lambda dtype, **kw: solve_mixed_precision(bp, theta, X0, opts, bulk_dtype=dtype, **kw)
    kern.reset_launches()
    (X, Y, info), cold = _walled(lambda: run(BF16))
    launches = _bf16_launches(kern)
    (X2, _, info2), warm = _walled(lambda: run(BF16))
    Xf, _, info_f = run(torch.float32)
    _check_certified("config 2 bf16 bulk", X, info, B, 3)
    _check_certified("config 2 bf16 bulk warm", X2, info2, B, 3)
    dX = float((X - Xf).abs().max())
    print(f"config 2 bf16 bulk, B={B}: certified {int(info.converged.sum())}/{B}, max pix {float(info.pix.max()):.3e}, "
          f"cold {cold:.3f} s, warm {warm:.3f} s on {smi}; max |dX| vs the float32 bulk {dX:.3e}; bf16 launches {launches}")
    _require(torch.allclose(X, Xf, rtol=BF16_RTOL, atol=BF16_ATOL), f"config 2 bf16: X off the float32 bulk's (max |dX| {dX:.3e})")
    _require(torch.equal(X2, X), "config 2 bf16: the warm run disagrees with the cold run")
    _check_launched("config 2 bf16 bulk", launches, BF16_PATH_KERNELS)
    fns = bp.instance_fns(theta)
    r, J = fns.residuals(X).cpu().numpy(), fns.jac_res(X).cpu().numpy()
    Xh, A, b_rhs = X.cpu().numpy(), bp.A.cpu().numpy(), bp.b.cpu().numpy()
    xl, xu = bp.xl.cpu().numpy(), bp.xu.cpu().numpy()
    sample = np.random.default_rng(0).choice(B, size=128, replace=False)
    agree = _oracle_agreement("config 2 bf16 bulk", [(Xh[i], r[i], J[i], None, None, A, b_rhs[i], xl, xu) for i in sample])
    _require(agree == 128, f"config 2 bf16: oracle agrees on {agree}/128")
    first = {name: _first_polish(bp, theta, X0, opts, 512, 8, dt) for name, dt in (("bf16", BF16), ("f32", torch.float32))}
    fallback = {"bf16": _fallback_lanes(info), "f32": _fallback_lanes(info_f)}
    print(f"config 2: lanes certified by the first polish from the bulk's point: bf16 {first['bf16']}/{B}, "
          f"float32 {first['f32']}/{B}; lanes sent to the f64 refine: bf16 {fallback['bf16']}, float32 {fallback['f32']}")
    walls = {"bf16": [], "f32": []}
    for k in range(BF16_TURNS):
        for name in (("bf16", "f32") if k % 2 == 0 else ("f32", "bf16")):
            walls[name].append(_walled(lambda: run(BF16 if name == "bf16" else torch.float32))[1])
    print(f"config 2 warm walls in turns on {smi}: bf16 bulk {['%.4f' % w for w in walls['bf16']]} s, "
          f"float32 bulk {['%.4f' % w for w in walls['f32']]} s")
    # Compaction with a bf16 bulk: the plain bf16 route's X, bit for bit
    # where every op's per-lane result is independent of its batch.
    Xc, _, info_c = run(BF16, bulk_compact=2)
    _check_certified("config 2 bf16 bulk_compact=2", Xc, info_c, B, 3)
    dXc = float((Xc - X).abs().max())
    print(f"config 2 bf16 bulk_compact=2: max |dX| vs the plain bf16 route {dXc:.3e} (bitwise {torch.equal(Xc, X)})")
    _require(torch.allclose(Xc, X, rtol=BF16_RTOL, atol=BF16_ATOL), "config 2 bf16: compaction off the plain route")
    out["config2"] = {"launches": launches, "cold_s": cold, "warm_s": warm, "walls": walls, "first_polish": first,
                      "fallback": fallback, "compact_dx": dXc}

    # sphere_family(1024): the bulk's thin_qr(Cᵀ) in bf16; the host certification.
    opts1 = SolverOptions(max_outer_iter=100, max_inner_iter=300)
    bp1, th1, X01 = sphere_family(1024, seed=0, device=dev)
    Xs32, _, is32 = solve_mixed_precision(bp1, th1, X01, opts1, chunk=512, certify="host")
    kern.reset_launches()
    (Xs, _, isb), wall_s = _walled(lambda: solve_mixed_precision(bp1, th1, X01, opts1, chunk=512, certify="host", bulk_dtype=BF16))
    launches_s = _bf16_launches(kern)
    ok32, okb = is32.converged, isb.converged
    both = ok32 & okb
    print(f"config 1 sphere_family B=1024 bf16 bulk certify=host: certified {int(okb.sum())}/1024 (float32 bulk "
          f"{int(ok32.sum())}/1024), max pix {float(isb.pix[okb].max()):.3e}, wall {wall_s:.3f} s, max |dX| vs the "
          f"float32 bulk on {int(both.sum())} lanes {float((Xs - Xs32)[both].abs().max()):.3e}; bf16 launches {launches_s}")
    _require(bool(okb[ok32].all()), "sphere bf16: a lane the float32 bulk certifies is not certified")
    _require(float(isb.pix[okb].max()) <= CERT_PIX and float(isb.feas[okb].max()) <= CERT_PIX, "sphere bf16: a certified lane misses 1.49e-8")
    _check_launched("sphere bf16 bulk", launches_s, BF16_PATH_KERNELS + ("batched_thin_qr",))
    out["sphere"] = {"launches": launches_s, "wall_s": wall_s, "certified": int(okb.sum())}

    # Config 3 with a bf16 bulk: the CholeskyQR2 operator from a bf16 J.
    B3, n3 = 64, 192
    opts3 = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp3, th3, X03 = dense_quadratic_family(B3, n=n3, d=1024, m=6, seed=3, dtype=torch.float64, device=dev)
    run3 = lambda **kw: solve_mixed_precision(bp3, th3, X03, opts3, chunk=B3, **kw)
    X3f, _, i3f = run3()
    kern.reset_launches()
    subproblem.reset_operator_builds()
    (X3, _, i3), wall3 = _walled(lambda: run3(bulk_dtype=BF16))
    launches3 = _bf16_launches(kern)
    builds = {f"{fact}/{dt}": k for (fact, dt), k in subproblem.OPERATOR_BUILDS.items()}
    _check_certified("config 3 bf16 bulk", X3, i3, B3, n3)
    print(f"config 3 bf16 bulk: certified {int(i3.converged.sum())}/{B3}, max pix {float(i3.pix.max()):.3e}, wall "
          f"{wall3:.3f} s on {smi}, operator builds {builds}, lanes certified by the polish {_polished_lanes(i3)}/{B3}, "
          f"sent to the f64 refine {_fallback_lanes(i3)}, max |dX| vs the float32 bulk {float((X3 - X3f).abs().max()):.3e}; "
          f"bf16 launches {launches3}")
    _require(builds.get("cholqr2/bfloat16", 0) > 0 and not [k for k in builds if k.endswith("/float32")],
             f"config 3 bf16: the bulk must build the CholeskyQR2 operator in bf16 only, built {builds}")
    _check_launched("config 3 bf16 bulk", launches3, BF16_PATH_KERNELS)

    # Config 3 with bulk_matmul_precision="default": TF32 in the bulk only,
    # but not in its minor loops, which the minor-loop kernel runs in float32
    # FMA whatever TF32 is allowed (they launch in both runs).
    res3 = {}
    for precision in ("highest", "default"):
        kw = {} if precision == "highest" else {"bulk_matmul_precision": precision}
        kern.reset_launches()
        (Xp, _, ip), wall_p = _walled(lambda: run3(**kw))
        minor = kern.LAUNCHES["minor_loop_r"]
        _check_certified(f"config 3 bulk_matmul_precision={precision}", Xp, ip, B3, n3)
        _require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must be off after the call")
        _require(minor > 0, f"config 3 bulk_matmul_precision={precision}: the minor-loop kernel did not launch")
        res3[precision] = {"wall_s": wall_p, "polished": _polished_lanes(ip), "fallback": _fallback_lanes(ip),
                           "dx_vs_highest": float((Xp - X3f).abs().max()), "minor_launches": minor}
    print(f"config 3 bulk matmul precision on {smi}: " + "; ".join(
        f"{p}: wall {v['wall_s']:.3f} s, lanes certified by the polish {v['polished']}/{B3}, sent to the f64 refine "
        f"{v['fallback']}, max |dX| vs the highest run {v['dx_vs_highest']:.3e}, minor_loop_r launches "
        f"{v['minor_launches']}" for p, v in res3.items()))
    out["config3"] = {"launches": launches3, "wall_s": wall3, "builds": builds, "polished": _polished_lanes(i3),
                      "fallback": _fallback_lanes(i3), "tf32": res3}
    print(f"phase 9 (reduced-precision bulk): {time.perf_counter() - t_phase:.1f} s")
    return out


# HOST_SYNCS of a float64 solve of the sphere fixture on the CPU before
# verbose was ported (tests/test_torch_logging.py pins it there).
SPHERE_SYNCS_BEFORE = 331


def _verbose_solve() -> dict:
    """A float64 `solve` of the sphere fixture on the card with verbose=True,
    its log written to a buffer, beside the same solve without it."""
    import io
    from benlsip_tpu_torch import SolverOptions, _loops, solve
    from benlsip_tpu_torch.harness.logging import set_log_stream
    from benlsip_tpu_torch.problems import sphere_regression as sr

    opts = dict(max_outer_iter=100, max_inner_iter=250)
    syncs = {}
    for where, x0 in (("card", sr.x0()), ("cpu", sr.x0(device="cpu"))):
        _loops.reset_host_syncs()
        out = solve(sr.make_problem(), x0, SolverOptions(**opts))
        syncs[where] = (_loops.HOST_SYNCS, int(out[2].outer_iters), int(out[2].inner_iters))
        if where == "card":
            x_off, info = out[0], out[2]
    buf = io.StringIO()
    set_log_stream(buf)
    try:
        _loops.reset_host_syncs()
        x_on = solve(sr.make_problem(), sr.x0(), SolverOptions(verbose=True, **opts))[0]
        syncs_on = _loops.HOST_SYNCS
    finally:
        set_log_stream(None)
    lines = buf.getvalue().splitlines()
    # The rows of each outer iteration's subproblem come before the table
    # that reports on it; the last table has none after it.
    segments = [[]]
    for line in lines:
        if re.match(r"^\s+Outer iter \d+$", line):
            segments.append([])
        elif re.match(r"^\s*\d+   \d\.\d{6}e[+-]\d+   ", line):
            segments[-1].append(line)
    tables, rows = len(segments) - 1, sum(map(len, segments))
    print(f"verbose solve (float64, card): {len(lines)} lines, {tables} outer tables, {rows} inner rows "
          f"(per outer iteration {[len(s) for s in segments[:-1]]}), outer {int(info.outer_iters)}, inner {int(info.inner_iters)}; "
          f"host syncs verbose=False {syncs['card'][0]} (CPU run {syncs['cpu'][0]}, CPU before the port of verbose "
          f"{SPHERE_SYNCS_BEFORE}), verbose=True {syncs_on}")
    for want in ("Problem dimensions", "benlsip_tpu_torch v-DEV", "Number of parameters.................:     3",
                 "Number of residuals..................:     4", "iter     AL value       ||s||        Δ          ρ"):
        _require(any(want in line for line in lines), f"verbose: the log lacks {want!r}")
    _require(tables == int(info.outer_iters) and all(segments[:-1]) and rows == int(info.inner_iters),
             f"verbose: {tables} tables and rows {[len(s) for s in segments]} for {int(info.outer_iters)} outer / "
             f"{int(info.inner_iters)} inner iterations")
    _require(torch.equal(x_on, x_off), "verbose: the log changed the solve")
    # verbose=True adds one sync per table or row written; verbose=False none.
    _require(syncs_on - syncs["card"][0] == tables + rows, f"verbose: {syncs_on - syncs['card'][0]} syncs for {tables + rows} lines")
    if syncs["card"][1:] == syncs["cpu"][1:]:
        _require(syncs["card"][0] == syncs["cpu"][0], f"verbose=False: host syncs card {syncs['card']} against CPU {syncs['cpu']}")
    return {"lines": len(lines), "tables": tables, "rows": rows, "syncs_off": syncs["card"][0], "syncs_on": syncs_on}


def _native_qp_against_device() -> dict:
    """`ops/native_qp` on config 2's 1,024 polyhedra against the device
    projection `ops/polyproject` from the same points."""
    from benlsip_tpu_torch.ops import native_qp
    from benlsip_tpu_torch.ops.polyproject import projection_polyhedron
    from benlsip_tpu_torch.problems.generators import exp_fit_family

    B, dev = 1024, torch.device("cuda:0")
    bp, _, X0 = exp_fit_family(B, d=32, seed=42, device=dev)
    poly = bp.polyhedron(3, torch.float64, B, dev)
    P = X0 + torch.as_tensor(np.random.default_rng(5).standard_normal((B, 3)) * 2.0, device=dev)
    V_dev, dev_s = _walled(lambda: projection_polyhedron(poly, P))
    A, b, xl, xu, Pn = (t.cpu().numpy() for t in (*poly, P))
    _require(native_qp.available(), "native_qp: the library did not build")
    V_host, host_s = _walled(lambda: np.stack([
        native_qp.projection_polyhedron_host(Pn[i], A[i], b[i], xl[i], xu[i]) for i in range(B)]))
    worst = float(np.abs(V_host - V_dev.cpu().numpy()).max())
    one = native_qp.projection_polyhedron_host(P[7], poly.A[7], poly.b[7], poly.xl[7], poly.xu[7])
    print(f"native_qp on config 2's {B} polyhedra (library {native_qp.library_path().name}): max |host - device| {worst:.3e}, "
          f"host {host_s:.3f} s, device {dev_s:.3f} s; a tensor in gives a tensor on {one.device}")
    _require(worst <= 1e-8, f"native_qp: host and device projections differ by {worst:.3e}")
    _require(one.device.type == "cuda" and torch.equal(one.cpu(), torch.from_numpy(V_host[7])),
             "native_qp: a CUDA tensor in must give the same projection on the card")
    return {"max_diff": worst, "host_s": host_s, "device_s": dev_s}


def _ill_conditioned(kern) -> dict:
    """`ill_conditioned_family(64, n=100, kappa=1e4)`: the float32 bulk, then
    the split polish with the QR and the LU factor and the all-f64 polish
    (the JAX package's test criterion: the QR route certifies the f64
    polish's set); the polish's qr_r([JZ; D]) at (64, 484, 100) is the panel
    QR kernel with a 4-column last panel."""
    from benlsip_tpu_torch import SolverOptions
    from benlsip_tpu_torch.batch.polish import sqp_polish, sqp_polish_split
    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched
    from benlsip_tpu_torch.problems.generators import ill_conditioned_family

    B, n, dev = 64, 100, torch.device("cuda:0")
    bp, th, X0 = ill_conditioned_family(B, n=n, kappa=1e4, seed=9, device=dev)
    bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(th, torch.float32)
    popts = SolverOptions(max_outer_iter=20, max_inner_iter=80)
    kern.reset_launches()
    X32 = solve_batched(bp32, th32, X0.float(), SolverOptions(max_outer_iter=20, max_inner_iter=80, crit_tol=1e-2))[0]
    qr = sqp_polish_split(bp32, th32, X32, bp, th, popts, num_steps=8, kkt_factorization="qr")[2].cpu()
    launches = dict(kern.LAUNCHES)
    lu = sqp_polish_split(bp32, th32, X32, bp, th, popts, num_steps=8, kkt_factorization="lu")[2].cpu()
    f64 = sqp_polish(bp, th, X32.double(), popts, num_steps=8)[2].cpu()
    print(f"ill_conditioned_family({B}, n={n}, kappa=1e4): certified by the split polish with QR {int(qr.sum())}/{B}, "
          f"with LU {int(lu.sum())}/{B}, by the f64 polish {int(f64.sum())}/{B}; QR set == f64 set: {torch.equal(qr, f64)}; "
          f"launches of the bulk and the QR polish {launches}")
    _check_launched("ill_conditioned bulk + QR polish", launches, CONFIG3_KERNELS)
    _require(torch.equal(qr, f64), "ill_conditioned: the QR polish's certified set differs from the f64 polish's")
    return {"launches": launches, "qr": int(qr.sum()), "lu": int(lu.sum()), "f64": int(f64.sum())}


def _ill_conditioned_pipeline(kern) -> dict:
    """`solve_mixed_precision` on `ill_conditioned_family(64, n=100,
    kappa=1e4)` with config 3's options, one cold call.  The lanes the
    polish leaves go to the f64 refine, a full solve in lockstep that runs
    the hardest lanes to their caps: minutes on the card, so it runs with
    --profile only."""
    from benlsip_tpu_torch import SolverOptions
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import ill_conditioned_family

    B = 64
    bp, th, X0 = ill_conditioned_family(B, n=100, kappa=1e4, seed=9, device=torch.device("cuda:0"))
    kern.reset_launches()
    (X, _, info), cold = _walled(lambda: solve_mixed_precision(bp, th, X0, SolverOptions(max_outer_iter=30, max_inner_iter=100),
                                                               chunk=B))
    launches = dict(kern.LAUNCHES)
    print(f"ill_conditioned solve_mixed_precision: certified {int(info.converged.sum())}/{B}, "
          f"max pix of certified {float(info.pix[info.converged].max()) if bool(info.converged.any()) else float('nan'):.3e}, "
          f"status counts {torch.bincount(info.status.cpu()).tolist()}, cold wall {cold:.3f} s, launches {launches}")
    _require(bool(torch.isfinite(X).all()), "ill_conditioned: the pipeline's X is not finite")
    _check_launched("ill_conditioned solve_mixed_precision", launches, CONFIG3_KERNELS)
    return {"launches": launches, "certified": int(info.converged.sum()), "cold_s": cold}


def phase_surface(kern, profile: bool) -> dict:
    """Phase 10: the surface ported last, on the card: the iteration log,
    its refusal under fuse=True, the native QP oracle and the
    ill-conditioned family through the repaired panel QR kernel (with
    `profile`, also its whole pipeline)."""
    from benlsip_tpu_torch import SolverOptions
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.problems.generators import exp_fit_family

    t0 = time.perf_counter()
    res = {"verbose": _verbose_solve()}
    bp, th, X0 = exp_fit_family(64, d=32, seed=42, device=torch.device("cuda:0"))
    try:
        solve_mixed_precision(bp, th, X0, SolverOptions(verbose=True), fuse=True)
    except ValueError as e:
        print(f"fuse=True with verbose=True refused: {e}")
    else:
        raise AssertionError("fuse=True with verbose=True must raise ValueError")
    res["native_qp"] = _native_qp_against_device()
    res["ill"] = _ill_conditioned(kern)
    if profile:
        res["ill_pipeline"] = _ill_conditioned_pipeline(kern)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return res


# A route whose lanes the fallback refine finished against the default
# route: the refine stops at pix ≤ 1.49e-8, not at the polish's f64 floor.
FALLBACK_ATOL = 1e-6


def _polish_route(kern, tag: str, run, B: int, n: int, X_ref=None, atol: float = FUSED_ATOL) -> dict:
    """One `polish_then_refine` route, cold: its launches read around the
    call, every lane certified at f64 KKT grade, X within rtol FUSED_RTOL /
    `atol` (the fused-vs-unfused bar by default) of the reference route's."""
    kern.reset_launches()
    (X, Y, info), wall = _walled(run)
    launches = {k: v for k, v in kern.LAUNCHES.items() if v}
    diff = "" if X_ref is None else f", max |dX| vs the default route {float((X.cpu() - X_ref.cpu()).abs().max()):.3e}"
    print(f"{tag}: certified {int(info.converged.sum())}/{B}, max pix {float(info.pix.max()):.3e}, "
          f"lanes refined by the fallback {int((info.outer_iters > 0).sum())}, X on {X.device.type}, "
          f"wall {wall:.3f} s{diff}, launches {launches}")
    _check_certified(tag, X, info, B, n)
    if X_ref is not None and not torch.allclose(X.cpu(), X_ref.cpu(), rtol=FUSED_RTOL, atol=atol):
        raise AssertionError(f"{tag}: X differs from the default route's beyond rtol {FUSED_RTOL} / atol {atol}")
    return {"X": X, "info": info, "wall_s": wall, "certified": int(info.converged.sum()),
            "launches": dict(kern.LAUNCHES)}


def phase_polish_routes(kern) -> dict:
    """Phase 11: `polish_then_refine`'s routes at full width, each after
    one float32 bulk of its family.  Config 2 (`exp_fit_family(1024)`):
    the split polish on the host route (`split="on"`: float32 QR factors
    on the card through `narrow_qr_r`, f64 chord steps on the CPU), the
    all-f64 polish on the CPU (`split="off"`, no kernel), the all-f64
    polish on the card with the LU and with the QR factor, and the default
    fused polish; each certifies 1024/1024, agrees with the default route
    and passes the KKT oracle on 128 lanes.  Config 3
    (`dense_quadratic_family(64, n=192)`): the all-f64 polish on the card
    with LU and QR, the split polish on the host route (the panel QR
    kernel's stacked form), and the fused polish with four lanes sent back
    to their cold start, `num_steps=2, rounds=1` and
    `fallback_device="cpu"`: the fallback refine runs on the CPU and the
    results come back there, every lane certified or converged."""
    from benlsip_tpu_torch.batch.polish import polish_then_refine
    from benlsip_tpu_torch.batch.refine import _cast_problem, _cast_tree
    from benlsip_tpu_torch.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu_torch.problems.generators import dense_quadratic_family, exp_fit_family
    from benlsip_tpu_torch.solver.options import SolverOptions

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    res = {}

    # Config 2: the bulk as solve_mixed_precision runs it (crit_tol 1e-2,
    # 8 inner iterations a subproblem at n <= 8), then five routes.
    B = 1024
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=torch.float64, device=dev)
    bp32, th32 = _cast_problem(bp, torch.float32, dev), _cast_tree(theta, torch.float32)
    bulk_opts = SolverOptions(max_outer_iter=40, max_inner_iter=8, crit_tol=1e-2)
    X32, bulk = _walled(lambda: solve_batched_chunked(bp32, th32, X0.float(), bulk_opts, chunk=512)[0].float())
    print(f"config 2 polish routes: the float32 bulk {bulk:.3f} s")
    route = lambda **kw: (lambda: polish_then_refine(bp, theta, X32, opts, num_steps=5, bp32=bp32, theta32=th32,
                                                     **kw))
    c2 = {"default (fused)": _polish_route(kern, "config 2 default (fused polish)", route(), B, 3)}
    X_ref = c2["default (fused)"]["X"]
    c2["cpu split=on"] = _polish_route(kern, "config 2 device='cpu' split='on'", route(device="cpu", split="on"),
                                       B, 3, X_ref)
    c2["cpu split=off"] = _polish_route(kern, "config 2 device='cpu' split='off'", route(device="cpu", split="off"),
                                        B, 3, X_ref)
    for kkt in ("lu", "qr"):
        c2[f"device split=off {kkt}"] = _polish_route(
            kern, f"config 2 device=None split='off' kkt_factorization='{kkt}'",
            route(split="off", kkt_factorization=kkt), B, 3, X_ref)
    _check_launched("config 2 default polish", c2["default (fused)"]["launches"], ("narrow_qr_r",))
    _check_launched("config 2 split polish", c2["cpu split=on"]["launches"], ("narrow_qr_r",))
    _require(not any(c2["cpu split=off"]["launches"].values()),
             "config 2 device='cpu' split='off': the all-f64 polish on the CPU must launch no kernel")
    for tag, r in c2.items():
        _require(_oracle_exp_fit(f"config 2 {tag}", bp, theta, r["X"].to(dev), 128, 0) == 128,
                 f"config 2 {tag}: the oracle must agree on 128 lanes")

    # Config 3: its bulk (crit_tol 1e-2, no inner cap at n = 192), then four routes.
    B3, n3 = 64, 192
    opts3 = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp3, theta3, X03 = dense_quadratic_family(B3, n=n3, d=1024, m=6, seed=3, dtype=torch.float64, device=dev)
    bp3_32, th3_32 = _cast_problem(bp3, torch.float32, dev), _cast_tree(theta3, torch.float32)
    bulk3 = SolverOptions(max_outer_iter=30, max_inner_iter=100, crit_tol=1e-2)
    X3, bulk_s3 = _walled(lambda: solve_batched_chunked(bp3_32, th3_32, X03.float(), bulk3, chunk=B3)[0].float())
    print(f"config 3 polish routes: the float32 bulk {bulk_s3:.3f} s")
    route3 = lambda X, **kw: (lambda: polish_then_refine(bp3, theta3, X, opts3, bp32=bp3_32, theta32=th3_32, **kw))
    c3 = {"default (fused)": _polish_route(kern, "config 3 default (fused polish)", route3(X3, num_steps=5), B3, n3)}
    X3_ref = c3["default (fused)"]["X"]
    for kkt in ("lu", "qr"):
        c3[f"device split=off {kkt}"] = _polish_route(
            kern, f"config 3 device=None split='off' kkt_factorization='{kkt}'",
            route3(X3, num_steps=5, split="off", kkt_factorization=kkt), B3, n3, X3_ref)
    c3["cpu split=on"] = _polish_route(kern, "config 3 device='cpu' split='on'",
                                       route3(X3, num_steps=5, device="cpu", split="on"), B3, n3, X3_ref)
    _check_launched("config 3 split polish", c3["cpu split=on"]["launches"], ("blocked_qr_r",))
    # Four lanes back at their cold start, one factor and one chord step, no
    # re-polish: those lanes go to the fallback refine, on the CPU.
    X3_forced = X3.clone()
    X3_forced[:4] = X03[:4].float()
    forced = _polish_route(kern, "config 3 fallback_device='cpu' (4 lanes at their cold start, num_steps=2, rounds=1)",
                           route3(X3_forced, num_steps=2, rounds=1, fallback_device="cpu"), B3, n3, X3_ref,
                           FALLBACK_ATOL)
    X, info = forced["X"], forced["info"]
    refined = int((info.outer_iters > 0).sum())
    _require(refined >= 1 and all(t.device.type == "cpu" for t in (X, *info)),
             f"config 3 fallback_device='cpu': {refined} lanes went to the fallback refine and X is on "
             f"{X.device}; at least one lane must, and every returned tensor must be on the CPU")
    c3["fallback_device=cpu"] = forced
    fns = bp3.instance_fns(theta3)
    J = fns.jac_res(X03)[0].cpu().numpy()   # shared by every instance (a stride-0 expand)
    A, b_rhs = bp3.A.cpu().numpy(), bp3.b.cpu().numpy()
    xl, xu = bp3.xl.cpu().numpy(), bp3.xu.cpu().numpy()
    for tag, r in c3.items():
        Xd = r["X"].to(dev)
        rr, Xn = fns.residuals(Xd).cpu().numpy(), Xd.cpu().numpy()
        agree = _oracle_agreement(f"config 3 {tag}", [(Xn[i], rr[i], J, None, None, A, b_rhs, xl, xu) for i in range(B3)])
        _require(agree == B3, f"config 3 {tag}: the oracle agrees on {agree}/{B3}")

    routes = {**{f"config 2 {k}": v for k, v in c2.items()}, **{f"config 3 {k}": v for k, v in c3.items()}}
    res["routes"] = {k: {"wall_s": v["wall_s"], "certified": v["certified"]} for k, v in routes.items()}
    res["launches"] = {name: {k: v["launches"][name] for k, v in routes.items()} for name in kern.LAUNCHES}
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; walls and certified counts {res['routes']}")
    return res


def main() -> None:
    smi = phase_card()   # raises without a CUDA device, before any output
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    print(f"card: {smi}")
    phase_build(kern)
    rec = phase_kernels(kern)
    _record_newton_shapes(kern)
    res = phase_slice(kern)
    resf = phase_fused(kern, smi, "--profile" in sys.argv[1:])
    res3 = phase_config3(kern)
    res3f = phase_fused_config3(kern, smi, res3, "--profile" in sys.argv[1:])
    res3f["split"] = phase_bulk_split()
    res3f["split_sphere"] = phase_bulk_split("densesphere-b64-fused")
    res1 = phase_config1(kern, smi)
    res4 = phase_config4(kern)
    res5 = phase_config5(kern, smi)
    resb = phase_bf16(kern, smi)
    ress = phase_surface(kern, "--profile" in sys.argv[1:])
    resp = phase_polish_routes(kern)
    if "--profile" in sys.argv[1:]:
        phase_profile(kern)
    src = "benlsip_tpu_torch/kernels/csrc/"
    sources = {
        "batched_cholesky": (src + "cholesky.cu", "benlsip_tpu/kernels/batched_linalg.py:74"),
        "batched_cho_solve": (src + "cho_solve.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "batched_thin_qr": (src + "thin_qr.cuh", "benlsip_tpu/kernels/batched_linalg.py:170"),
        "narrow_qr_r": (src + "thin_qr.cuh", "benlsip_tpu/kernels/batched_linalg.py:170"),
        "masked_aat_cholesky": (src + "masked_aat_cholesky.cu", "benlsip_tpu/kernels/batched_linalg.py:74"),
        "project_tangent": (src + "project_tangent.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "blocked_qr_r": (src + "blocked_qr.cu", "benlsip_tpu/kernels/batched_linalg.py:170"),
        "polyhedron_newton": (src + "polyhedron_newton.cu", "benlsip_tpu/kernels/batched_linalg.py:119"),
        "minor_direction_r": (src + "minor_direction_r.cu", "none: the JAX package's projected CG is lax.while_loop code"),
        "minor_loop_r": (src + "minor_loop_r.cu", "none: the JAX package's minor loop is lax.while_loop code"),
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
        if name == "batched_cho_solve":
            # Its body runs inside project_tangent and polyhedron_newton (the
            # dual Newton of ops/polyproject, its last caller on the paths).
            k["on_path_as"] = "project_tangent, polyhedron_newton"
        if name == "polyhedron_newton":
            # The split form's own source and the device code both share;
            # the (B, m, n, dtype, plan) the paths called it at, with counts.
            k["sources"] = [source, src + "polyhedron_newton_split.cu", src + "polyhedron_newton.cuh"]
            k["path_shapes"] = {"x".join(map(str, key)): v for key, v in sorted(NEWTON_SEEN.items())}
        if name in MINOR_KERNELS:
            # One device code of the minor iteration; the projections run the
            # device function of project_tangent's header, the loop's factor
            # masked_aat_cholesky's.
            k["sources"] = [source, src + "minor_iteration.cuh", src + "project_tangent.cuh"] + (
                [src + "masked_aat.cuh"] if name == "minor_loop_r" else [])
            k["launches_bulk_split_per_call"] = {split["cell"]: split[f"{name}_launches_per_call"]
                                                 for split in (res3f["split"], res3f["split_sphere"])}
        if name in ("batched_thin_qr", "narrow_qr_r"):
            # One kernel, two entries (Q and R; R only, of S or of the
            # stacked [JZ; diag(dbot)]); the device code is in the header,
            # one source a dtype.
            k["sources"] = [src + f for f in ("thin_qr.cuh", "thin_qr.cu", "thin_qr_bf16.cu", "thin_qr_f64.cu")]
        if name == "blocked_qr_r":
            # Configs 1 and 2 (n = 3) have no wide QR and launch it 0 times.
            k["launches_config3_host"] = res3["launches_host"][name]
        own4, own5 = res4["launches"][name], res5["launches"][name]
        own_ill = ress["ill"]["launches"][name]
        own_routes = resp["launches"][name]
        k.update({"launches": own2 + own3 + own1 + own1_b1 + own4 + own5 + own_ill + sum(own_routes.values()),
                  "launches_config2": own2,
                  "launches_config3": own3,
                  "launches_config1": own1, "launches_config1_host": res1["host"]["launches"][name],
                  "launches_config1_single_f32": own1_b1, "launches_config4": own4,
                  # The fused kernels' config-4 launches by plan (blocks per instance; 1 the warp form).
                  **({"launches_config4_by_plan": {k.split(" S=")[1]: v for k, v in res4["by_plan"].items()
                                                   if k.startswith(name + " ")}}
                     if name in ("masked_aat_cholesky", "project_tangent") else {}),
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
                  "captured_config3_fused": res3f["captured"][name],
                  "launches_config3_fused": res3f["executed"][name],
                  "launches_config1_fused": res1["fused"]["launches"][name],
                  # Phase 10: ill_conditioned_family(64, n=100): the bulk with the
                  # QR split polish.
                  "launches_ill_conditioned": ress["ill"]["launches"][name],
                  # Phase 11: each polish_then_refine route's cold call, after its bulk.
                  "launches_polish_routes": own_routes, **rec[name]})
        if name in SMALL_KERNELS + ("polyhedron_newton",):
            # Phase 9: the bf16 instantiation's launches on each bf16 path's
            # cold run; the small kernels' check against the bf16 plain
            # version and their times (the dual Newton's bf16 checks and times
            # are phase 3's, in its record).
            k.update({"launches_bf16_config2": resb["config2"]["launches"][name],
                      "launches_bf16_config1_sphere": resb["sphere"]["launches"][name],
                      "launches_bf16_config3": resb["config3"]["launches"][name], **resb["rec"].get(name, {})})
        kernels.append(k)
    plans_checked = set(rec["polyhedron_newton"]["plans_checked"])
    print(f"polyhedron_newton: (B, m, n, dtype, plan) the paths called it at, with counts: {NEWTON_SEEN}")
    _require({key[-1] for key in NEWTON_SEEN} <= plans_checked,
             f"polyhedron_newton: the paths ran a layout phase 3 did not check ({NEWTON_SEEN}, checked {plans_checked})")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
