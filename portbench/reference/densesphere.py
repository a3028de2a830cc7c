"""Reference model of the norm-constrained dense family, in plain float64:
r(x) = J x − y with one J shared by every lane, the sphere
c(x) = xᵀx − ρ² (p = 1, ρ² per lane), shared equalities A x = b and the
box.

The criticality is that of the Lagrangian gradient Jᵀr + 2x·ŷ over the
linear polyhedron, as the port certifies it, with the reference's own
multiplier ŷ: the least-squares fit of the sphere's and A's multipliers
to −Jᵀr over the coordinates strictly inside the box (not at a bound by
the KKT oracle's 1e-9 relative margin).  It reads nothing of the port's
multipliers.  The KKT oracle sees the sphere as a row of the equalities,
linearized at x itself: A' = [A; 2xᵀ], b' = [b; xᵀx + ρ²], so that
A'x − b' = (Ax − b, c(x)) and the row's multiplier is free.

lanes: {"y": (N, d), "rho2": (N, 1)}; shared: {"J": (d, n), "A": (m, n), "b": (m,), "xl", "xu": (n,)}.
"""
from __future__ import annotations

import numpy as np
import torch

from .numpy_solver import solve_one_numpy

# Relative margin of a coordinate at a bound (the KKT oracle's active_atol).
ACTIVE_ATOL = 1e-9


def multiplier(X: torch.Tensor, g: torch.Tensor, shared: dict) -> torch.Tensor:
    """ŷ (N,): the sphere's multiplier of the least-squares fit
    min ‖(g + 2x·ŷ + Aᵀλ) on the free coordinates‖ over (ŷ, λ), by a thin
    QR of the free rows of [2x, Aᵀ]."""
    xl, xu = shared["xl"], shared["xu"]
    margin = ACTIVE_ATOL * (1.0 + X.abs())
    free = ((X - xl > margin) & (xu - X > margin)).to(X.dtype)                   # (N, n)
    E = torch.cat([2.0 * X.unsqueeze(-1), shared["A"].T.expand(X.shape[0], -1, -1)], dim=-1)
    Q, R = torch.linalg.qr(E * free.unsqueeze(-1))                                # (N, n, 1+m)
    rhs = -(Q.mT @ (g * free).unsqueeze(-1))
    return torch.linalg.solve_triangular(R, rhs, upper=True)[:, 0, 0]


def gradient(X: torch.Tensor, lanes: dict, shared: dict) -> torch.Tensor:
    """The Lagrangian gradient Jᵀr + 2x·ŷ of each lane, X (N, n)."""
    J = shared["J"]
    g = (X @ J.T - lanes["y"]) @ J
    return g + 2.0 * X * multiplier(X, g, shared).unsqueeze(-1)


def polyhedron(lanes: dict, shared: dict):
    b = shared["b"].expand(lanes["y"].shape[0], -1)
    return shared["A"], b, shared["xl"], shared["xu"]


def kkt_arrays(x: np.ndarray, lane: dict, shared: dict):
    """(r, J, A', b', xl, xu) of one lane at x, numpy float64, with the
    sphere as the row 2xᵀ of A' and xᵀx + ρ² in b'."""
    J = shared["J"]
    A = np.vstack([shared["A"], 2.0 * x[None]])
    b = np.concatenate([shared["b"], [x @ x + lane["rho2"][0]]])
    return J @ x - lane["y"], J, A, b, shared["xl"], shared["xu"]


def _newton(x, y, held, J, t, rho2, A, b, steps):
    """Newton's method on the KKT equations of min ½‖Jx − t‖² s.t.
    xᵀx = ρ², Ax = b with the coordinates of `held` fixed: the
    Lagrangian's Hessian JᵀJ + 2y·I, the rows [2xᵀ; A] on the free
    coordinates.  Returns (x, y, λ) at the smallest KKT residual it met."""
    free = ~held
    k, m = int(free.sum()), A.shape[0]
    H0 = (J.T @ J)[np.ix_(free, free)]

    def residual(x, y, lam):
        g = J.T @ (J @ x - t) + 2.0 * y * x + A.T @ lam
        return np.concatenate([g[free], [x @ x - rho2], A @ x - b])

    lam = np.linalg.lstsq(A[:, free].T, -(J.T @ (J @ x - t) + 2.0 * y * x)[free], rcond=None)[0]
    best = (x, y, lam, np.linalg.norm(residual(x, y, lam)))
    for _ in range(steps):
        E = np.vstack([2.0 * x[None, free], A[:, free]])                    # (1 + m, k)
        K = np.block([[H0 + 2.0 * y * np.eye(k), E.T], [E, np.zeros((1 + m, 1 + m))]])
        d = np.linalg.solve(K, -residual(x, y, lam))
        xn = x.copy()
        xn[free] += d[:k]
        yn, lamn = y + d[k], lam + d[k + 1:]
        res = np.linalg.norm(residual(xn, yn, lamn))
        if not np.isfinite(res) or res > best[3]:
            break
        x, y, lam, best = xn, yn, lamn, (xn, yn, lamn, res)
    return best[:3]


def active_set_newton(x: np.ndarray, y: float, J: np.ndarray, t: np.ndarray, rho2: float, A: np.ndarray,
                      b: np.ndarray, xl: np.ndarray, xu: np.ndarray, rounds: int = 10, steps: int = 4) -> np.ndarray:
    """A primal-dual active-set loop of `_newton` from (x, y): hold the
    coordinates at a bound (within ACTIVE_ATOL), solve the KKT equations
    of the rest by Newton's method, then release each held coordinate
    whose bound multiplier has the wrong sign and hold each free one that
    left the box (clipped back), until the set stays put.  The frozen
    solver stops ~1e-8 from the KKT point (the float32 control's offset)
    and now and then short of the active set; this takes its answer there."""
    x = np.clip(x, xl, xu)
    margin = ACTIVE_ATOL * (1.0 + np.abs(x))
    at_lo, at_hi = x - xl <= margin, xu - x <= margin
    for _ in range(rounds):
        x, y, lam = _newton(x, y, at_lo | at_hi, J, t, rho2, A, b, steps)
        g = J.T @ (J @ x - t) + 2.0 * y * x + A.T @ lam
        release_lo, release_hi = at_lo & (g < 0), at_hi & (g > 0)
        out_lo, out_hi = ~at_lo & ~at_hi & (x < xl), ~at_lo & ~at_hi & (x > xu)
        if not (release_lo | release_hi | out_lo | out_hi).any():
            break
        at_lo = (at_lo & ~release_lo) | out_lo
        at_hi = (at_hi & ~release_hi) | out_hi
        x = np.where(at_lo, xl, np.where(at_hi, xu, x))
    return x


def numpy_solve(lane: dict, shared: dict, x0: np.ndarray, crit_tol: float) -> np.ndarray:
    """The frozen single-core solver from x0, with the sphere as its
    nonlinear constraint (its default "boundary" step rule), then
    `active_set_newton` from its answer and multiplier."""
    J, t, rho2 = shared["J"], lane["y"], float(lane["rho2"][0])
    x, y, _ = solve_one_numpy(lambda x: J @ x - t, lambda x: J, lambda x: np.array([x @ x - rho2]),
                              lambda x: 2.0 * x[None], shared["A"], shared["b"], shared["xl"], shared["xu"], x0,
                              crit_tol=crit_tol)
    return active_set_newton(x, float(y[0]), J, t, rho2, shared["A"], shared["b"], shared["xl"], shared["xu"])
