"""Mixed-precision pipeline: f32 bulk solve + f64 certification (PyTorch
port of `solve_mixed_precision` and `refine_f64` in
`benlsip_tpu/batch/refine.py`).

1. bulk phase — the full TRALCNLLS iteration in float32, to a loose
   criticality tolerance (it only has to identify the active set and land
   in the polish's Newton basin);
2. certification — the SQP polish (float32 factors, float64 chord steps,
   exact-projection certificate) with the full f64 refine as the fallback
   for the lanes it cannot certify.

`certify="auto"` (or "device") certifies on the device the data are on,
the f64 fallback included: the H100 has native float64, so the JAX
package's TPU thresholds and `refine_device="cpu"` (chosen for a TPU that
emulates f64) have no counterpart here.  `certify="host"` is the JAX host
certification on request: the f64 chord phase and the fallback run on the
CPU (for n ≥ 64 after f32 factors on the device, `batch/polish.py`), and
the results come back on the CPU.

The bulk has three scheduling routes besides the plain chunked solve, each
with the same per-instance results: converged-instance compaction
(`bulk_compact=K`, `batch/compact.py`), difficulty-ordered chunks
(`sort_by_difficulty`, `batch/buckets.py`) and the overlapped pipeline
(`pipeline_overlap`: a worker thread certifies chunk i while the main
thread drives chunk i+1's bulk).  `fuse=True` with the polish and the
device certification runs `batch/fused_small.solve_small_fused`
(CUDA-graph replays on the card).  Every "auto" resolves to the plain
path until a measurement on the card says otherwise.  The routes exclude
each other: the JAX pipeline runs one and silently ignores the others,
where the port raises `ValueError`.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Tuple

import torch

from .._batched import cat_batches, tree_map
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from .vmap_solve import BatchedProblem, map_poly_fields, solve_batched_chunked

Tensor = torch.Tensor
# Seconds of the last overlapped pipeline: its wall, and its stages summed
# over the chunks — the bulk on the main thread, the certification on the
# worker.
OVERLAP_STAGES: dict = {}


def _cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def _cast_problem(bp: BatchedProblem, dtype: torch.dtype, device) -> BatchedProblem:
    """bp with its constraint data cast to dtype on device."""
    cast = lambda a: None if a is None else a.to(device=device, dtype=dtype)
    return dataclasses.replace(bp, A=cast(bp.A), b=cast(bp.b), xl=cast(bp.xl), xu=cast(bp.xu))


def refine_f64(
    bp: BatchedProblem, theta, X: Tensor, options: SolverOptions = SolverOptions(),
    max_outer: int = 10, chunk: int = 512,
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Refine batched solutions X to f64 KKT grade with the full solver
    (warm start, at most `max_outer` outer iterations) on X's device."""
    opts = dataclasses.replace(options, max_outer_iter=max_outer)
    dev = X.device
    bp64 = _cast_problem(bp, torch.float64, dev)
    theta64 = _cast_tree(tree_map(lambda a: a.to(dev), theta), torch.float64)
    return solve_batched_chunked(bp64, theta64, X.to(torch.float64), opts, chunk=chunk)


def _resolve_bulk_max_inner(bulk_max_inner, n: int, polish: bool):
    """"auto": cap the bulk phase's per-subproblem TR iterations at 8 for
    small instances (n ≤ 8) when the polish absorbs the slack; it changes
    the bulk iterates, so it is kept for parity with the JAX pipeline."""
    if bulk_max_inner != "auto":
        return bulk_max_inner
    return 8 if (polish and n <= 8) else None


def true_f32_matmuls() -> None:
    """Bulk matmuls stay true f32 (the JAX package's matmul_precision="highest")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _resolve_bulk_compact(bulk_compact, B: int, chunk: int, polish: bool,
                          sort_by_difficulty: bool = False):
    """"auto": off, as in the JAX package, where the rule was set on a TPU
    behind a relay.  An int is the outer horizon of `solve_batched_compact`;
    None is off."""
    if bulk_compact != "auto":
        return bulk_compact
    return None


def _exclusive_routes(fuse, bulk_compact, sort_by_difficulty: bool, pipeline_overlap: bool, polish: bool) -> None:
    """Raise where a route would silently ignore another knob."""
    chosen = [name for name, on in (("fuse=True", fuse is True), ("bulk_compact", bulk_compact is not None),
                                    ("sort_by_difficulty", sort_by_difficulty),
                                    ("pipeline_overlap", pipeline_overlap)) if on]
    if len(chosen) > 1:
        raise ValueError(f"solve_mixed_precision: {' and '.join(chosen)} are separate routes; choose one")
    if pipeline_overlap and not polish:
        raise ValueError("solve_mixed_precision: pipeline_overlap overlaps the bulk with the polish; it needs polish=True")


def solve_mixed_precision(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    sort_by_difficulty: bool = False,
    sort_chunk: int = 128,
    polish: bool = True,
    polish_steps: int = 5,
    bulk_crit_tol=1e-2,
    certify: str = "auto",
    pipeline_overlap: bool = False,
    bulk_dtype: torch.dtype = torch.float32,
    bulk_max_inner="auto",
    bulk_compact="auto",
    fuse="auto",
) -> Tuple[Tensor, Tensor, SolveInfo]:
    """f32 bulk solve + f64 certification on X0's device; returns f64
    (X, Y, SolveInfo).

    certify: "auto" or "device" certifies on X0's device; "host" runs the
    f64 chord phase and the fallback on the CPU and returns CPU tensors
    (see the module docstring).  polish=False refines every instance with
    the full f64 solver instead, on the certification's device.
    bulk_crit_tol relaxes the bulk phase's criticality tolerance (None:
    the f32 floor); bulk_max_inner caps its inner
    iterations ("auto": 8 for n ≤ 8).  fuse=True stages the polished
    device pipeline as `solve_small_fused` (with polish=False or
    certify="host" it is the plain path, as in JAX where it fuses only the
    device certification).  bulk_compact=K runs the bulk through
    `solve_batched_compact` at outer horizon K ("auto" and None: off);
    sort_by_difficulty runs it in pilot-ranked chunks of `sort_chunk`;
    pipeline_overlap certifies chunk i on a worker thread while the bulk
    of chunk i+1 runs.  Each gives the plain path's per-instance results,
    and each is a route of its own: two of them, or one with fuse=True,
    raise `ValueError`.  Only a float32 bulk_dtype is ported.
    """
    if fuse not in (True, False, "auto"):
        raise ValueError(f"fuse={fuse!r}: expected True, False or 'auto'")
    bulk_compact = _resolve_bulk_compact(bulk_compact, X0.shape[0], min(chunk, X0.shape[0]), polish,
                                         sort_by_difficulty)
    _exclusive_routes(fuse, bulk_compact, sort_by_difficulty, pipeline_overlap, polish)
    if certify not in ("auto", "device", "host"):
        raise ValueError(f"certify={certify!r}: expected 'auto', 'device' or 'host'")
    host = certify == "host"
    if bulk_dtype != torch.float32:
        raise NotImplementedError(f"solve_mixed_precision(bulk_dtype={bulk_dtype}): not ported yet")

    bulk_max_inner = _resolve_bulk_max_inner(bulk_max_inner, X0.shape[-1], polish)
    if fuse is True and polish and not host:
        from .fused_small import solve_small_fused

        return solve_small_fused(
            bp, theta, X0, options, chunk=chunk, polish_steps=polish_steps,
            bulk_crit_tol=bulk_crit_tol, bulk_max_inner=bulk_max_inner,
        )

    true_f32_matmuls()
    dev = X0.device
    theta32 = _cast_tree(theta, torch.float32)
    bp32 = _cast_problem(bp, torch.float32, dev)
    X0_32 = X0.to(torch.float32)

    bulk_opts = options
    if polish and bulk_crit_tol is not None:
        bulk_opts = dataclasses.replace(bulk_opts, crit_tol=bulk_crit_tol)
    if polish and bulk_max_inner is not None:
        bulk_opts = dataclasses.replace(
            bulk_opts, max_inner_iter=min(bulk_max_inner, options.max_inner_iter)
        )
    if pipeline_overlap:
        return _overlapped_pipeline(bp, theta, bp32, theta32, X0_32, options, bulk_opts, chunk, polish_steps, host)
    if bulk_compact is not None:
        from .compact import solve_batched_compact

        X32, _, _ = solve_batched_compact(bp32, theta32, X0_32, bulk_opts, chunk=chunk, stage_outer=bulk_compact)
    elif sort_by_difficulty:
        from .buckets import solve_batched_sorted

        X32, _, _ = solve_batched_sorted(bp32, theta32, X0_32, bulk_opts, chunk=sort_chunk)
    else:
        X32, _, _ = solve_batched_chunked(bp32, theta32, X0_32, bulk_opts, chunk=chunk)
    if polish:
        from .polish import polish_then_refine

        return polish_then_refine(
            bp, theta, X32, options, num_steps=polish_steps, chunk=chunk,
            device="cpu" if host else None, bp32=bp32, theta32=theta32,
        )
    return refine_f64(bp, theta, X32.cpu() if host else X32, options, chunk=chunk)


def _overlapped_pipeline(bp, theta, bp32, theta32, X0_32, options, bulk_opts, chunk: int, polish_steps: int,
                         host: bool) -> Tuple[Tensor, Tensor, SolveInfo]:
    """Chunk-pipelined bulk and certification: the main thread drives the
    bulk of chunk i+1 while one worker thread certifies chunk i.

    The JAX package issues every bulk chunk up front and lets its async
    dispatch queue them on the device.  Eager loops here sync the host on
    every trip, so issuing "up front" would queue nothing; the overlap is
    between the host's work on two chunks instead, and on the device with
    `certify="host"`, whose chord steps run on the CPU.  Every chunk is
    certified where the plain path certifies, so the results are
    concatenated on that one device."""
    from .polish import polish_then_refine

    B = X0_32.shape[0]
    csz = max(min(chunk, B), 1)
    take = lambda sl: (lambda a: a[sl])

    def certify(sl, X32):
        t0 = time.perf_counter()
        out = polish_then_refine(
            map_poly_fields(bp, take(sl)), tree_map(take(sl), theta), X32, options, num_steps=polish_steps,
            chunk=csz, device="cpu" if host else None,
            bp32=map_poly_fields(bp32, take(sl)), theta32=tree_map(take(sl), theta32),
        )
        return out, time.perf_counter() - t0

    t_start = time.perf_counter()
    bulk_s = 0.0
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as worker:
        pending = []
        for start in range(0, B, csz):
            sl = slice(start, min(start + csz, B))
            t0 = time.perf_counter()
            X32, _, _ = solve_batched_chunked(map_poly_fields(bp32, take(sl)), tree_map(take(sl), theta32),
                                              X0_32[sl], bulk_opts, chunk=csz)
            bulk_s += time.perf_counter() - t0
            pending.append(worker.submit(certify, sl, X32))
        parts = [p.result() for p in pending]
    OVERLAP_STAGES.update(wall_s=time.perf_counter() - t_start, bulk_s=bulk_s,
                          certify_s=sum(t for _, t in parts))
    return cat_batches([out for out, _ in parts])
