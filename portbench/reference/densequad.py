"""Reference model of the dense linear family, in plain float64:
r(x) = J x − y with one J shared by every lane, shared equalities A x = b
and the box.

lanes: {"y": (N, d)}; shared: {"J": (d, n), "A": (m, n), "b": (m,), "xl", "xu": (n,)}.
"""
from __future__ import annotations

import numpy as np
import torch

from .numpy_solver import solve_one_numpy


def gradient(X: torch.Tensor, lanes: dict, shared: dict) -> torch.Tensor:
    """Jᵀr of each lane, X (N, n)."""
    J = shared["J"]
    return (X @ J.T - lanes["y"]) @ J


def polyhedron(lanes: dict, shared: dict):
    b = shared["b"].expand(lanes["y"].shape[0], -1)
    return shared["A"], b, shared["xl"], shared["xu"]


def kkt_arrays(x: np.ndarray, lane: dict, shared: dict):
    """(r, J, A, b, xl, xu) of one lane at x, numpy float64."""
    J = shared["J"]
    return J @ x - lane["y"], J, shared["A"], shared["b"], shared["xl"], shared["xu"]


def numpy_solve(lane: dict, shared: dict, x0: np.ndarray, crit_tol: float) -> np.ndarray:
    """The frozen single-core solver from x0 (its default "boundary" step
    rule, as the port's `solve_dense_lsq_numpy` runs this family)."""
    J, y = shared["J"], lane["y"]
    n = J.shape[1]
    x, _, _ = solve_one_numpy(lambda x: J @ x - y, lambda x: J, lambda x: np.zeros(0), lambda x: np.zeros((0, n)),
                              shared["A"], shared["b"], shared["xl"], shared["xu"], x0, crit_tol=crit_tol)
    return x
