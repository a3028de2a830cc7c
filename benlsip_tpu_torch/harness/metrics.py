"""Structured metrics for batched runs (PyTorch port of
`benlsip_tpu/harness/metrics.py`).

At batch scale the useful observables are distributional: `batch_summary`
reduces a batched `SolveInfo` to quantiles and status counts, and
`MetricsWriter` appends JSONL rows.
"""
from __future__ import annotations

import json
import time
from typing import IO

import numpy as np
import torch

from ..solver.outer import SolveInfo


def _numpy(a, dtype=None) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a if dtype is None else a.astype(dtype)


def batch_summary(info: SolveInfo) -> dict:
    """Quantiles of criticality, feasibility and iteration counts, and the
    status mix, of a batched SolveInfo (tensors on any device)."""
    pix = _numpy(info.pix, np.float64)
    feas = _numpy(info.feas, np.float64)
    inner = _numpy(info.inner_iters, np.float64)
    outer = _numpy(info.outer_iters, np.float64)
    status = np.atleast_1d(_numpy(info.status))
    qs = [0.5, 0.9, 0.99, 1.0]

    def q(a):
        a = np.atleast_1d(a)
        return {f"p{int(100*x)}": float(np.quantile(a, x)) for x in qs}

    uniq, counts = np.unique(status, return_counts=True)
    return {
        "batch": int(status.shape[0]),
        "converged_frac": float(np.mean(np.atleast_1d(_numpy(info.converged)))),
        "status_counts": {int(u): int(c) for u, c in zip(uniq, counts)},
        "pix": q(pix),
        "feas": q(feas),
        "outer_iters": q(outer),
        "inner_iters": q(inner),
    }


class MetricsWriter:
    """Append-only JSONL metrics sink (a path or an open text stream)."""

    def __init__(self, path_or_stream):
        if hasattr(path_or_stream, "write"):
            self._stream: IO = path_or_stream
            self._own = False
        else:
            self._stream = open(path_or_stream, "a")
            self._own = True

    def write(self, record: dict, **extra) -> None:
        row = {"ts": time.time(), **record, **extra}
        self._stream.write(json.dumps(row) + "\n")
        self._stream.flush()

    def close(self) -> None:
        if self._own:
            self._stream.close()
