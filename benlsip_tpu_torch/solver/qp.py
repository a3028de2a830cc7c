"""Standalone quadratic-programming entry points (PyTorch port of
`benlsip_tpu/solver/qp.py`).

The reference carries an equality-constrained QP surface in its dead code
(`solve_quadratic`: projected CG on a quadratic over Ax = b).  Sign
convention: this module minimizes ½xᵀQx + cᵀx, while the reference's
`solve_quadratic` minimizes ½xᵀHx − cᵀx — anyone porting a reference call
site must pass `-c` here.

* `solve_qp` with equality constraints only: a feasible point by a
  min-norm correction, then projected CG on the tangent space, reusing the
  solver's own `projected_cg` on an `AlHessian` that carries Q as its
  materialized operator G.
* with box bounds: a Cholesky lift onto the NLS solver — ½xᵀQx + cᵀx =
  ½‖Lᵀx + L⁻¹c‖² + const for Q = LLᵀ, so the full active-set machinery
  handles the box + equalities with `linear_residuals=True` (Q is
  constant).

Where the JAX module is "jittable and vmappable", this one is batch-first:
every argument may carry a leading batch axis (Q (B, n, n), c (B, n),
A (B, m, n), b (B, m), bounds (B, n)) and arguments without one are shared
by the batch; unbatched Q, c, A and b give unbatched results.  Both paths return
(x, nu, QPInfo) with nu the equality multipliers (stationarity
Qx + c + Aᵀnu = 0 in least squares).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import mtv, mv, norm
from .._device import as_tensor
from ..ops.al import AlHessian
from ..ops.cholesky import chol_linalg, cho_solve_lower
from ..ops.constraints import Polyhedron, make_active_set
from .api import NLSFunctions, empty_jac_nlcons, empty_nlconstraints
from .cg import projected_cg
from .options import SolverOptions
from .outer import solve_fixed_point
from .status import CG_NEGATIVE_CURVATURE

Tensor = torch.Tensor


class QPInfo(NamedTuple):
    converged: Tensor      # bool: stationarity reached (or NLS certified)
    status: Tensor         # CG_* code (equality path) / solver status (box path)
    iters: Tensor          # CG iterations / solver inner iterations
    stationarity: Tensor   # ‖Qx + c + Aᵀnu‖ (+ free-coordinate form for box)


def _chol_psd(M: Tensor, reg: float) -> Tensor:
    n = M.shape[-1]
    shift = reg * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n
    return chol_linalg(M + shift[:, None, None] * torch.eye(n, dtype=M.dtype, device=M.device))


def _batched(a: Tensor, base_rank: int, B: int) -> Tensor:
    """`a` with a leading batch axis of B (a stride-0 expand when shared)."""
    return a if a.ndim > base_rank else a.expand((B,) + a.shape)


def solve_qp(
    Q,
    c,
    A=None,
    b=None,
    xl=None,
    xu=None,
    x0=None,
    tol: Optional[float] = None,
    reg: float = 0.0,
    options: Optional[SolverOptions] = None,
    device=None,
) -> Tuple[Tensor, Tensor, QPInfo]:
    """Solve  min ½xᵀQx + cᵀx  s.t.  Ax = b,  xl ≤ x ≤ xu.

    Q must be symmetric positive semidefinite (positive definite for the
    box path, which Cholesky-factorizes it; `reg` adds a scale-relative
    shift reg·tr(Q)/n·I when needed).  The box path runs the NLS solver
    and inherits its options (pass `options` to tune).  Tensors keep
    their device; lists and numpy arrays are created on `device` (None:
    the CUDA card).
    """
    c = as_tensor(c, device=device)
    kw = {"dtype": c.dtype, "device": c.device}
    n = c.shape[-1]
    if A is None:
        A, b = torch.zeros((0, n), **kw), torch.zeros((0,), **kw)
    Q, A, b = as_tensor(Q, **kw), as_tensor(A, **kw), as_tensor(b, **kw)
    lead = [a.shape[0] for a, rank in ((Q, 2), (c, 1), (A, 2), (b, 1)) if a.ndim > rank]
    single = not lead
    B = 1 if single else lead[0]
    Q, c, A, b = _batched(Q, 2, B), _batched(c, 1, B), _batched(A, 2, B), _batched(b, 1, B)
    xs = torch.zeros((B, n), **kw) if x0 is None else _batched(as_tensor(x0, **kw), 1, B)

    if xl is not None or xu is not None:
        def bound(v, fill):
            v = torch.full((n,), fill, **kw) if v is None else as_tensor(v, **kw)
            return _batched(torch.broadcast_to(v, v.shape[:-1] + (n,)), 1, B)

        out = _solve_qp_boxed(Q, c, A, b, bound(xl, -math.inf), bound(xu, math.inf), xs, reg, options, tol)
    else:
        out = _solve_qp_equality(Q, c, A, b, xs, tol)
    if single:
        x, nu, info = out
        return x[0], nu[0], QPInfo(*[f[0] for f in info])
    return out


def _solve_qp_equality(Q, c, A, b, xs, tol):
    """Equality path on batched operands."""
    dtype = c.dtype
    B, n = c.shape
    m = A.shape[-2]
    if tol is None:
        tol = float(torch.finfo(dtype).eps) ** 0.5

    # Feasible point: min-norm correction x_f = x0 − Aᵀ(AAᵀ)⁻¹(Ax0 − b).
    if m:
        eps = torch.finfo(dtype).eps
        AAt = A @ A.mT
        trace = torch.diagonal(AAt, dim1=-2, dim2=-1).sum(-1)
        L_aat = chol_linalg(AAt + eps * trace[:, None, None] * torch.eye(m, dtype=dtype, device=c.device))
        xs = xs - mtv(A, cho_solve_lower(L_aat, mv(A, xs) - b))

    # Projected CG on the tangent space {w : Aw = 0} from the feasible
    # point: min_w ½wᵀQw + (Qxs + c)ᵀw, the box disabled.
    inf = torch.full((B, n), float("inf"), dtype=dtype, device=c.device)
    poly = Polyhedron(A=A, b=b, xl=-inf, xu=inf)
    aset = make_active_set(poly, torch.zeros((B, n), dtype=torch.bool, device=c.device))
    zero_rows = torch.zeros((B, 0, n), dtype=dtype, device=c.device)
    H = AlHessian(zero_rows, zero_rows, torch.zeros((B,), dtype=dtype, device=c.device), G=Q)
    g0 = mv(Q, xs) + c
    w, status, iters = projected_cg(g0, H, -inf, inf, poly, aset, kappa2=tol)
    x = xs + w

    # Equality multipliers: least-squares stationarity Qx + c + Aᵀnu = 0.
    g = mv(Q, x) + c
    if m:
        nu = -cho_solve_lower(L_aat, mv(A, g))
        stat = norm(g + mtv(A, nu))
    else:
        nu = torch.zeros((B, 0), dtype=dtype, device=c.device)
        stat = norm(g)
    scale = 1.0 + norm(g0)
    ok = (stat <= tol * scale) & (status != CG_NEGATIVE_CURVATURE)
    return x, nu, QPInfo(converged=ok, status=status, iters=iters, stationarity=stat)


def _solve_qp_boxed(Q, c, A, b, xl, xu, xs, reg, options, tol=None):
    """Box path: Cholesky lift onto the NLS solver (see module docstring).

    `tol` maps onto the solver's criticality tolerance so the equality
    and box paths honor the same knob."""
    dtype = c.dtype
    L = _chol_psd(Q, max(reg, float(torch.finfo(dtype).eps)))
    # ½‖Lᵀx + u‖² = ½xᵀQx + cᵀx + const  with  Lu = c.
    u = torch.linalg.solve_triangular(L, c.unsqueeze(-1), upper=False).squeeze(-1)
    Lt = L.mT

    fns = NLSFunctions(
        residuals=lambda X: mv(Lt, X) + u,
        nlconstraints=empty_nlconstraints,
        jac_res=lambda X: Lt,
        jac_nlcons=empty_jac_nlcons,
    )
    upd = {"linear_residuals": True}
    if tol is not None:
        upd["crit_tol"] = tol
    opts = dataclasses.replace(options or SolverOptions(), **upd)
    x, _, info = solve_fixed_point(fns, Polyhedron(A=A, b=b, xl=xl, xu=xu), xs, opts)

    # Equality multipliers + free-coordinate stationarity for the report.
    # nu must be fit on the FREE coordinates only: active bounds carry
    # their own duals, so the all-coordinate least squares would smear
    # them into nu and misreport stationarity.
    g = mv(Q, x) + c
    m = A.shape[-2]
    gap = torch.finfo(dtype).eps ** 0.5 * (1 + torch.abs(x))
    on_lo = torch.isfinite(xl) & (x - xl <= gap)
    on_hi = torch.isfinite(xu) & (xu - x <= gap)
    freem = (~(on_lo | on_hi)).to(dtype)
    if m:
        # Min-norm least squares (rank-deficient where coordinates are fixed).
        nu = mv(torch.linalg.pinv((A * freem.unsqueeze(-2)).mT), -(freem * g))
        gL = g + mtv(A, nu)
    else:
        nu = torch.zeros((x.shape[0], 0), dtype=dtype, device=c.device)
        gL = g
    return x, nu, QPInfo(
        converged=info.converged, status=info.status,
        iters=info.inner_iters, stationarity=norm(freem * gL),
    )
