"""Reference model of the exponential-fit family, in plain float64:
r_j(x) = a·exp(−b t_j) + c − y_j for x = (a, b, c), with the box and the
per-lane equality a + c = y(0) that the generator states.

lanes: {"t", "y": (N, d), "b": (N, 1)}; shared: {"A": (1, 3), "xl", "xu": (3,)}.
"""
from __future__ import annotations

import numpy as np
import torch

from .numpy_solver import solve_one_numpy


def gradient(X: torch.Tensor, lanes: dict, shared: dict) -> torch.Tensor:
    """Jᵀr of each lane, X (N, 3)."""
    a, b, c = X[:, :1], X[:, 1:2], X[:, 2:]
    t = lanes["t"]
    e = torch.exp(-b * t)
    r = a * e + c - lanes["y"]
    return torch.stack([(e * r).sum(-1), -(a * t * e * r).sum(-1), r.sum(-1)], dim=-1)


def polyhedron(lanes: dict, shared: dict):
    return shared["A"], lanes["b"], shared["xl"], shared["xu"]


def _model(t: np.ndarray, y: np.ndarray):
    def residuals(x):
        return x[0] * np.exp(-x[1] * t) + x[2] - y

    def jac(x):
        e = np.exp(-x[1] * t)
        return np.stack([e, -x[0] * t * e, np.ones_like(t)], axis=1)

    return residuals, jac


def kkt_arrays(x: np.ndarray, lane: dict, shared: dict):
    """(r, J, A, b, xl, xu) of one lane at x, numpy float64."""
    residuals, jac = _model(lane["t"], lane["y"])
    return residuals(x), jac(x), shared["A"], lane["b"], shared["xl"], shared["xu"]


def numpy_solve(lane: dict, shared: dict, x0: np.ndarray, crit_tol: float) -> np.ndarray:
    """The frozen single-core solver from x0 (its "clip" step rule, as the
    port's `solve_exp_fit_numpy` runs this family)."""
    residuals, jac = _model(lane["t"], lane["y"])
    x, _, _ = solve_one_numpy(residuals, jac, lambda x: np.zeros(0), lambda x: np.zeros((0, 3)),
                              shared["A"], lane["b"], shared["xl"], shared["xu"], x0,
                              crit_tol=crit_tol, step_rule="clip")
    return x
