"""Checkpoint/resume of a long batched solve (PyTorch port of
`benlsip_tpu/harness/checkpoint.py`).

The solver's state between outer iterations is the `OuterCarry`, a
NamedTuple of tensors: a checkpointed solve runs `save_every` outer
iterations at a time and saves the carry; a resumed one loads it, holds
every tensor to the shape and dtype of the run's own initial carry, and
goes on from there.  Cutting the outer loop between iterations leaves
every lane's trajectory as it was, so a resumed solve returns
`solve_fixed_point`'s results.

A step is one file, written under a temporary name and renamed into
place (`save_step`), so a kill never leaves a half-written step; loading
is `torch.load(weights_only=True)`, held to an explicit target (`hold_to`).  The sweep
driver (`harness/sweep.py`) keeps its steps the same way.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

from .._loops import host_any, masked_while
from ..solver.options import SolverOptions
from ..solver.outer import (
    OuterCarry,
    SolveInfo,
    default_atol,
    finalize,
    outer_body,
    outer_done,
    outer_init,
)
from ..solver.subproblem import linear_gram_cache

Tensor = torch.Tensor
_STEP = re.compile(r"step_(\d+)\.pt")


def _step_path(directory: str, k: int) -> str:
    return os.path.join(directory, f"step_{k:08d}.pt")


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP.fullmatch, os.listdir(directory)) if m]
    return max(steps) if steps else None


def save_step(directory: str, k: int, tensors: Dict[str, Tensor]) -> None:
    """Commit step k: `tensors` (moved to the CPU) written to a temporary
    file, flushed to disk and renamed into place; then the older steps are
    removed."""
    os.makedirs(directory, exist_ok=True)
    path = _step_path(directory, k)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save({name: t.detach().cpu() for name, t in tensors.items()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for name in os.listdir(directory):
        m = _STEP.fullmatch(name)
        if m and int(m.group(1)) < k:
            os.remove(os.path.join(directory, name))


def read_step(directory: str, k: int) -> Dict[str, Tensor]:
    """Step k's tensors as saved, on the CPU (`weights_only`: tensors and
    plain containers only)."""
    return torch.load(_step_path(directory, k), map_location="cpu", weights_only=True)


def hold_to(raw: Dict[str, Tensor], target: Dict[str, Tensor], where: str) -> Dict[str, Tensor]:
    """The loaded tensors `raw`, each held to the shape and dtype of its
    entry of `target` and moved to that entry's device; a missing, extra
    or mismatched entry raises ValueError."""
    if set(raw) != set(target):
        raise ValueError(f"{where} holds {sorted(raw)}, this run expects {sorted(target)}")
    for name, want in target.items():
        got = raw[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"{where}: {name} is {got.dtype} {tuple(got.shape)}, "
                             f"this run has {want.dtype} {tuple(want.shape)}")
    return {name: raw[name].to(want.device) for name, want in target.items()}


class CheckpointedSolve:
    """Batched solve in steps of `save_every` outer iterations, with the
    carry saved after each step in `directory`; a run resumes from the
    newest step there."""

    def __init__(self, bp, options: SolverOptions, directory: str, save_every: int = 5):
        if save_every < 1:
            raise ValueError(f"save_every={save_every}: at least one outer iteration a step")
        self.bp = bp
        self.options = options
        self.dir = os.path.abspath(directory)
        self.save_every = save_every

    def run(self, theta, X0: Tensor, max_steps: Optional[int] = None,
            resume: bool = True) -> Tuple[Tensor, Tensor, SolveInfo]:
        """Run to completion, or until `max_steps` outer iterations in all
        (those before a resume included), saving after every step; returns
        (X, Y, SolveInfo) of the carry reached, on X0's device."""
        B, n = X0.shape
        opts = self.options.resolve_tols(X0.dtype)
        atol = default_atol(X0.dtype)
        fns = self.bp.instance_fns(theta)
        poly = self.bp.polyhedron(n, X0.dtype, B, X0.device)
        carry = outer_init(fns, poly, X0, opts)
        k = latest_step(self.dir) if resume else None
        if k is None:
            k = 0
        else:
            carry = OuterCarry(**hold_to(read_step(self.dir, k), carry._asdict(), f"checkpoint step {k} in {self.dir}"))
        gram_cache = linear_gram_cache(fns, carry.x, opts)
        cap = opts.max_outer_iter + 1 if max_steps is None else max_steps
        while k < cap and host_any(~outer_done(carry, opts)):
            # Every running lane has made k outer iterations (outer = k + 1).
            trips = min(self.save_every, cap - k)
            cond = lambda c, stop=k + trips: ~outer_done(c, opts) & (c.outer <= stop)
            carry = masked_while(
                cond, lambda c, act: outer_body(fns, poly, opts, atol, c, active=act, gram_cache=gram_cache),
                carry, cond(carry), trips,
            )
            k += trips
            save_step(self.dir, k, carry._asdict())
        return finalize(fns, carry, opts)
