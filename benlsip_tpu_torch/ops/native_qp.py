"""ctypes bindings to the native (C++) polyhedral-projection QP solver
(PyTorch port of `benlsip_tpu/ops/native_qp.py`).

The exact projection onto {v : Av = b, l ≤ v ≤ u} on the host, by a
dependency-free dual active-set Newton solver: the oracle that the
reference's tests get from Ipopt.  The port keeps its own copy of the
source (`benlsip_tpu_torch/native/polyqp.cpp`) and builds it with g++ at
first use into `benlsip_tpu_torch/native/_build/` (gitignored; apart from
the CUDA kernels' `kernels/_build/`, and never the JAX package's
`native/`), under a name keyed on a hash of the source.  The solve itself
is numpy on the host; the device twin is
`ops/polyproject.projection_polyhedron`.
`available()` reports whether the library could be built and loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent.parent / "native" / "polyqp.cpp"
BUILD_DIR = _SRC.parent / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the built library lives: a function of the source and flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpolyqp-{digest}.so"


def _build(lib: Path) -> bool:
    """Compile into a temporary file beside `lib` and rename it into place,
    so that processes building at once never load a half-written file."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True, capture_output=True)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.polyqp_project.restype = ctypes.c_int
        lib.polyqp_project.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, ctypes.c_double,
                                       ctypes.c_int]
        lib.polyqp_project_batch.restype = ctypes.c_int
        lib.polyqp_project_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp,
                                             ctypes.c_double, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is built (or can be) and loads."""
    return _load() is not None


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def projection_polyhedron_host(x, A, b, l, u, tol: float = 1e-12, max_iter: int = 200):
    """Project x (n,) or (batch, n) onto {v : Av = b, l ≤ v ≤ u}, one
    polyhedron (A (m, n), b (m,), l, u (n,)) for every row of x.

    Inputs may be tensors or numpy arrays; the solve runs on the host in
    float64.  The result is a float64 tensor on x's device when x is a
    tensor, else a numpy array.  Raises RuntimeError if the native library
    is unavailable or a solve does not reach tol.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native polyqp library unavailable (no g++?)")
    xh = _host(x)
    A, b, l, u = _host(A), _host(b), _host(l), _host(u)
    m, n = A.shape if A.size else (0, xh.shape[-1])
    v = np.empty_like(xh)
    if xh.ndim == 1:
        rc = lib.polyqp_project(n, m, _as_c(xh), _as_c(A), _as_c(b), _as_c(l), _as_c(u), _as_c(v), tol, max_iter)
        if rc < 0:
            raise RuntimeError("polyqp_project failed to converge")
    else:
        rc = lib.polyqp_project_batch(xh.shape[0], n, m, _as_c(xh), _as_c(A), _as_c(b), _as_c(l), _as_c(u), _as_c(v),
                                      tol, max_iter)
        if rc < 0:
            raise RuntimeError(f"polyqp_project_batch failed at instance {-rc - 1}")
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(v).to(x.device)
    return v
