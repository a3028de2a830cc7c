"""Checkpointed large sweeps, BASELINE config 5 (PyTorch port of
`benlsip_tpu/harness/sweep.py`): chunk-granular resume.

A 100k-instance sweep is a sequence of independent, deterministic chunk
solves (the mixed-precision pipeline, `batch/refine.py`), so saving the
completed chunks' *results* makes resume exact: a resumed sweep recomputes
nothing that was saved, and computes the remaining chunks with the same
code on the same inputs as an uninterrupted run would.

Step k is one `torch.save` file holding the full-size result buffers
with chunks [0, k) filled and the sweep's geometry (B, sweep_chunk),
committed atomically (`harness/checkpoint.save_step`).  A resume loads it
with `torch.load(weights_only=True)` and holds every buffer to the shape
and dtype this run produces for its own (B, n, p); a step of another
geometry, or one without geometry, is refused.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional, Tuple

import torch

from .._batched import tree_map
from ..batch.vmap_solve import BatchedProblem, map_poly_fields
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from .checkpoint import hold_to, latest_step, read_step, save_step

Tensor = torch.Tensor
_INT_FIELDS = ("status", "outer_iters", "inner_iters", "minor_iters", "cg_iters")


def _buffers(B: int, n: int, p: int, dtype: torch.dtype) -> Dict[str, Tensor]:
    """Zeroed CPU result buffers of a sweep: X (B, n), Y (B, p) and each
    SolveInfo field (B,) in the dtype the solve returns it in."""
    out = {"X": torch.zeros((B, n), dtype=dtype), "Y": torch.zeros((B, p), dtype=dtype)}
    for f in SolveInfo._fields:
        out["info_" + f] = torch.zeros((B,), dtype=torch.bool if f == "converged"
                                       else torch.int32 if f in _INT_FIELDS else dtype)
    return out


class CheckpointedSweep:
    """A chunked sweep with a checkpoint after every chunk; a run resumes
    by skipping the chunks of the newest step in `directory`."""

    def __init__(
        self,
        bp: BatchedProblem,
        options: SolverOptions,
        directory: str,
        sweep_chunk: int = 4096,
        chunk: int = 512,
        mixed_precision: bool = True,
        pipeline_kwargs: Optional[dict] = None,
        throttle_s: float = 0.0,
    ):
        self.bp = bp
        self.options = options
        self.dir = os.path.abspath(directory)
        self.sweep_chunk = sweep_chunk
        self.chunk = chunk
        self.mixed_precision = mixed_precision
        self.pipeline_kwargs = dict(pipeline_kwargs or {})
        # A pause after each checkpoint: widens the window for kill/resume
        # tests (and rate-limits a shared file system).
        self.throttle_s = throttle_s

    def _solve_chunk(self, bp_c, theta_c, X0_c):
        if self.mixed_precision:
            from ..batch.refine import solve_mixed_precision

            return solve_mixed_precision(bp_c, theta_c, X0_c, self.options, chunk=self.chunk, **self.pipeline_kwargs)
        from ..batch.vmap_solve import solve_batched_chunked

        return solve_batched_chunked(bp_c, theta_c, X0_c, self.options, chunk=self.chunk)

    def _template(self, theta, X0: Tensor) -> Dict[str, Tensor]:
        """This run's buffers (the restore target): p from the constraints
        of instance 0, the dtype the solve returns."""
        B, n = X0.shape
        p = 0
        if self.bp.nlconstraints is not None:
            p = self.bp.instance_fns(tree_map(lambda a: a[:1], theta)).nlconstraints(X0[:1]).shape[-1]
        return _buffers(B, n, p, torch.float64 if self.mixed_precision else X0.dtype)

    def _restore(self, k: int, buffers: Dict[str, Tensor]) -> Dict[str, Tensor]:
        B = buffers["X"].shape[0]
        raw = read_step(self.dir, k)
        geometry = raw.pop("meta_geometry", None)
        if geometry is None:
            raise ValueError(
                f"checkpoint in {self.dir} has no geometry metadata: cannot verify that it matches "
                f"B={B}, sweep_chunk={self.sweep_chunk}; resume refused (use resume=False or a fresh directory)"
            )
        gB, gchunk = (int(v) for v in geometry)
        if (gB, gchunk) != (B, self.sweep_chunk):
            raise ValueError(
                f"checkpoint in {self.dir} was written with B={gB}, sweep_chunk={gchunk}; this run has "
                f"B={B}, sweep_chunk={self.sweep_chunk}: refusing to resume across sweep geometries "
                "(use a fresh directory)"
            )
        return hold_to(raw, buffers, f"checkpoint step {k} in {self.dir}")

    def run(
        self,
        theta,
        X0: Tensor,
        resume: bool = True,
        stop_after_chunks: Optional[int] = None,
        chunk_callback=None,
    ) -> Tuple[Tensor, Tensor, SolveInfo, int]:
        """Run the sweep; returns (X, Y, info, resumed_from_chunk), CPU tensors.

        `stop_after_chunks` bounds this call's work (preemption without a
        kill): the checkpoint is committed, then RuntimeError is raised, and
        a later call resumes.  `chunk_callback(k)` fires just before chunk
        k's compute — where a kill lands mid-chunk, whose inputs are pure
        slices of (theta, X0), so the resumed run recomputes it exactly.
        """
        B = X0.shape[0]
        n_chunks = math.ceil(B / self.sweep_chunk)
        if n_chunks == 0:
            raise ValueError("empty sweep: B == 0")
        buffers = self._template(theta, X0)
        start = latest_step(self.dir) if resume else None
        if start is None:
            start = 0
        else:
            buffers = self._restore(start, buffers)
        geometry = torch.tensor([B, self.sweep_chunk], dtype=torch.int64)

        for done, k in enumerate(range(start, n_chunks)):
            if stop_after_chunks is not None and done >= stop_after_chunks:
                raise RuntimeError(f"sweep stopped after {done} chunks (chunk {k}/{n_chunks}); "
                                   "checkpoint saved — rerun to resume")
            if chunk_callback is not None:
                chunk_callback(k)
            sl = slice(k * self.sweep_chunk, min((k + 1) * self.sweep_chunk, B))
            take = lambda a: a[sl]
            Xc, Yc, info_c = self._solve_chunk(map_poly_fields(self.bp, take), tree_map(take, theta), X0[sl])
            for name, part in (("X", Xc), ("Y", Yc), *(("info_" + f, t) for f, t in zip(SolveInfo._fields, info_c))):
                if part.dtype != buffers[name].dtype:
                    raise TypeError(f"sweep chunk {k}: {name} came back {part.dtype}, expected {buffers[name].dtype}")
                buffers[name][sl] = part.cpu()
            save_step(self.dir, k + 1, {**buffers, "meta_geometry": geometry})
            if self.throttle_s and k + 1 < n_chunks:
                time.sleep(self.throttle_s)

        info = SolveInfo(*[buffers["info_" + f] for f in SolveInfo._fields])
        return buffers["X"], buffers["Y"], info, start


def run_sweep(
    bp: BatchedProblem,
    theta,
    X0: Tensor,
    options: SolverOptions,
    directory: str,
    **kwargs,
) -> Tuple[Tensor, Tensor, SolveInfo, int, float]:
    """One-call checkpointed sweep; returns (X, Y, info, resumed_from, wall_s)."""
    sweep = CheckpointedSweep(bp, options, directory, **kwargs)
    t0 = time.perf_counter()
    X, Y, info, resumed_from = sweep.run(theta, X0)
    return X, Y, info, resumed_from, time.perf_counter() - t0
