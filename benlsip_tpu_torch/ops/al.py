"""Augmented-Lagrangian evaluation and the Gauss-Newton Hessian operator
(PyTorch port of `benlsip_tpu/ops/al.py`).

* m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc
* g(x) = Jᵀr + Cᵀ(y + mu c)
* H    = JᵀJ + mu CᵀC, held as the triple (J, C, mu) and optionally
  materialized as an (n, n) operator: the Gram matrix G (`with_gram`) or
  a triangular R with RᵀR = H (`with_r_factor` by QR,
  `with_r_factor_cholqr2` by CholeskyQR2).  The solver materializes one
  when the Jacobian is tall (`solver/subproblem.resolve_operator_route`).

`axis` names the mesh dim the residual dimension is sharded over in the
explicit-collective blocked mode (`dist/sharded.solve_large_blocked_shardmap`,
`SolverOptions.spmd_axis`): J and r then hold this rank's rows, and every
contraction over them (rᵀr, Jᵀr, JᵀJ, ‖Jv‖²) carries one `psum`.  Under an
axis the operator may also be kept row-sharded: `with_gram_rows` (this
rank's rows of G) and `with_r_factor_cholqr2(layout="sharded")` (this
rank's rows of R).  p == 0 (no nonlinear constraints) is carried as a
zero-row C.

A bfloat16 J follows the JAX package's three rules: the cached JᵀJ
(`gram_j`, `gram_j_rows`) accumulates in float32, the row-sharded Gram
keeps the operator's dtype, and CholeskyQR2 computes in float32 and
returns R in bf16.  The Gram operator itself (`with_gram`) is a bf16
product, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._batched import mtv, mv, vdot

Tensor = torch.Tensor


class AlHessian(NamedTuple):
    """Gauss-Newton Hessian H = JᵀJ + mu CᵀC, batched: the factors, and
    optionally the materialized Gram matrix G or a factor R with RᵀR = H,
    whole or (under an axis) as this rank's rows of either."""

    J: Tensor   # (B, d, n); this rank's d rows under an axis
    C: Tensor   # (B, p, n), p may be 0; replicated
    mu: Tensor  # (B,)
    G: Optional[Tensor] = None  # (B, n, n) JᵀJ + mu CᵀC
    R: Optional[Tensor] = None  # (B, k, n) R of [J; sqrt(mu) C]
    G_rows: Optional[Tensor] = None  # (B, n/D, n) this rank's rows of G (`with_gram_rows`)
    R_rows: Optional[Tensor] = None  # (B, n/D, n) this rank's rows of the CholeskyQR2 R


def _psum(x: Tensor, axis: Optional[str]) -> Tensor:
    if axis is None:
        return x
    from ..dist.collectives import psum

    return psum(x, axis)


def _rows_per_rank(n: int, axis: str, what: str) -> int:
    from ..dist.collectives import axis_size

    D = axis_size(axis)
    if n % D:
        raise ValueError(f"n={n} not divisible by mesh axis size {D} for the sharded {what} layout")
    return n // D


def _own_rows(M: Tensor, axis: str, dim: int, what: str) -> Tensor:
    """This rank's n/D slice of M along `dim`."""
    from ..dist.collectives import axis_index

    per = _rows_per_rank(M.shape[dim], axis, what)
    return M.narrow(dim, axis_index(axis) * per, per)


def al_value(rx: Tensor, cx: Tensor, y: Tensor, mu: Tensor, axis: Optional[str] = None) -> Tensor:
    """m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc per lane (rᵀr summed over `axis`)."""
    return _psum(0.5 * vdot(rx, rx), axis) + vdot(y, cx) + 0.5 * mu * vdot(cx, cx)


def al_gradient(J: Tensor, C: Tensor, rx: Tensor, y_bar: Tensor, axis: Optional[str] = None) -> Tensor:
    """g = Jᵀ rx + Cᵀ y_bar with y_bar = y + mu c (Jᵀ rx summed over `axis`)."""
    return _psum(mtv(J, rx), axis) + mtv(C, y_bar)


def _mu(H: AlHessian) -> Tensor:
    return H.mu[:, None, None].to(H.J.dtype)


def gram_j(J: Tensor, axis: Optional[str] = None) -> Tensor:
    """The (reduced) JᵀJ block of the Gram operator, (B, n, n).
    Affine-residual problems (SolverOptions.linear_residuals) compute it
    once per solve and hand it to `with_gram` / `with_r_factor_cholqr2` as
    `Gj=` on every refresh.  A bf16 J accumulates in float32, the precision
    the operator is built in."""
    J = _compute(J)
    return _psum(J.mT @ J, axis)


def _compute(t: Tensor) -> Tensor:
    """t in the dtype an operator is built in: float32 for bf16."""
    return t.float() if t.dtype == torch.bfloat16 else t


def with_gram(H: AlHessian, axis: Optional[str] = None, Gj: Optional[Tensor] = None) -> AlHessian:
    """Materialize G = JᵀJ + mu CᵀC (`Gj` skips the JᵀJ product and its psum)."""
    jtj = _psum(H.J.mT @ H.J, axis) if Gj is None else Gj.to(H.J.dtype)
    G = jtj if H.C.shape[-2] == 0 else jtj + _mu(H) * (H.C.mT @ H.C)
    return AlHessian(H.J, H.C, H.mu, G=G)


def gram_j_rows(J: Tensor, axis: str, schedule: str = "xla") -> Tensor:
    """This rank's n/D rows of the reduced JᵀJ, (B, n/D, n): the constant-J
    cache of the row-sharded layout.  "xla" reduce-scatters the local
    partial JᵀJ (`psum_scatter`); "ring" builds one (n/D, n) row chunk
    Jᵀ[:, chunk] J per ring hop (`ring_psum_scatter_lazy`), so the full
    (n, n) partial never exists.  A bf16 J accumulates in float32, as in
    `gram_j`."""
    from ..dist.collectives import psum_scatter, ring_psum_scatter_lazy

    J = _compute(J)
    per = _rows_per_rank(J.shape[-1], axis, "Gram")
    if schedule == "ring":
        def chunk(c, J_):
            return J_.narrow(-1, c * per, per).mT @ J_

        return ring_psum_scatter_lazy(chunk, axis, operand=J)
    return psum_scatter(J.mT @ J, axis, dim=-2)


def with_gram_rows(
    H: AlHessian, axis: str, schedule: str = "xla", Gj_rows: Optional[Tensor] = None
) -> AlHessian:
    """Materialize the Gram operator row-sharded over `axis`: this rank
    keeps its n/D rows of G (n²/D memory; the refresh is a reduce-scatter,
    half an all-reduce's traffic) and every H·v pays one n-vector
    all_gather.  The mu CᵀC term is added on this rank's rows (C is
    replicated and p small).  The rows keep the operator's dtype: a float32
    cache of a bf16 J is cast back."""
    _rows_per_rank(H.J.shape[-1], axis, "Gram")
    rows = (gram_j_rows(H.J, axis, schedule) if Gj_rows is None else Gj_rows).to(H.J.dtype)
    if H.C.shape[-2]:
        C_loc = _own_rows(H.C, axis, -1, "Gram")   # (B, p, n/D)
        rows = rows + _mu(H) * (C_loc.mT @ H.C)
    return AlHessian(H.J, H.C, H.mu, G_rows=rows)


def _stacked(H: AlHessian) -> Tensor:
    """S = [J; sqrt(mu)·C], so that SᵀS = H."""
    if H.C.shape[-2] == 0:
        return H.J
    return torch.cat([H.J, torch.sqrt(_mu(H)) * H.C], dim=-2)


def with_r_factor(H: AlHessian) -> AlHessian:
    """Materialize R from a thin QR of S = [J; sqrt(mu)·C] (`ops/qr.qr_r`:
    the MGS kernel for few columns, Householder otherwise)."""
    from .qr import qr_r

    return AlHessian(H.J, H.C, H.mu, R=qr_r(_stacked(H)))


def with_r_factor_cholqr2(
    H: AlHessian, axis: Optional[str] = None, layout: str = "replicated", Gj: Optional[Tensor] = None,
) -> AlHessian:
    """Materialize R with RᵀR = JᵀJ + mu CᵀC by CholeskyQR2 with the
    implicit refinement pass from the formed Gram (`Gj` skips the JᵀJ
    product).  Without an axis a lane whose implicit refinement breaks down
    is rescued through the explicit pass on S = [J; sqrt(mu) C], that lane
    only.  Under `axis` the Gram is psummed once and the refinement is
    local; the explicit pass would need a second psum, so a broken lane
    keeps R = R₁ (shift grade, as in the JAX package).  layout="sharded"
    keeps this rank's n/D rows of R (H·v: one n-vector psum).  A bf16
    operator is built in float32 and R is rounded back to bf16."""
    from .qr import _rescued_chol_upper, cholqr2i_r, implicit_refine_upper

    Hc = AlHessian(_compute(H.J), _compute(H.C), _compute(H.mu))
    G = with_gram(Hc, axis, Gj).G
    if axis is None:
        return AlHessian(H.J, H.C, H.mu, R=cholqr2i_r(_stacked(Hc), G).to(H.J.dtype))
    R = implicit_refine_upper(G, _rescued_chol_upper(G)).to(H.J.dtype)
    if layout == "sharded":
        return AlHessian(H.J, H.C, H.mu, R_rows=_own_rows(R, axis, -2, "R"))
    return AlHessian(H.J, H.C, H.mu, R=R)


def hv(H: AlHessian, v: Tensor, axis: Optional[str] = None) -> Tensor:
    """H @ v: Rᵀ(Rv) or Gv when materialized (row-sharded: a psum of the
    rows' Rᵀ(Rv), or an all_gather of the rows of Gv), else
    Jᵀ(Jv) + mu Cᵀ(Cv) with Jᵀ(Jv) summed over `axis`."""
    if H.R_rows is not None:
        return _psum(mtv(H.R_rows, mv(H.R_rows, v)), axis)
    if H.G_rows is not None:
        from ..dist.collectives import all_gather

        return all_gather(mv(H.G_rows, v), axis, dim=-1)
    if H.R is not None:
        return mtv(H.R, mv(H.R, v))
    if H.G is not None:
        return mv(H.G, v)
    jv = _psum(mtv(H.J, mv(H.J, v)), axis)
    if H.C.shape[-2] == 0:
        return jv
    return jv + H.mu.unsqueeze(-1) * mtv(H.C, mv(H.C, v))


def vhv(H: AlHessian, v: Tensor, axis: Optional[str] = None) -> Tensor:
    """vᵀHv: ‖Rv‖² or vᵀGv when materialized (row-sharded: one scalar psum
    of the rows' share), else ‖Jv‖² + mu ‖Cv‖² with ‖Jv‖² summed over `axis`."""
    if H.R_rows is not None:
        Rv = mv(H.R_rows, v)
        return _psum(vdot(Rv, Rv), axis)
    if H.G_rows is not None:
        return _psum(vdot(_own_rows(v, axis, -1, "Gram"), mv(H.G_rows, v)), axis)
    if H.R is not None:
        Rv = mv(H.R, v)
        return vdot(Rv, Rv)
    if H.G is not None:
        return vdot(v, mv(H.G, v))
    Jv = mv(H.J, v)
    Cv = mv(H.C, v)
    return _psum(vdot(Jv, Jv), axis) + H.mu * vdot(Cv, Cv)


def first_derivatives(x: Tensor, y: Tensor, mu: Tensor, rx: Tensor, cx: Tensor, jac_res, jac_nlcons,
                      axis: Optional[str] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(y_bar, Jx, Cx, g) at x (B, n) given rx, cx already computed there;
    `jac_res` and `jac_nlcons` are batched callables."""
    Jx = jac_res(x)
    Cx = jac_nlcons(x)
    y_bar = y + mu.unsqueeze(-1) * cx
    return y_bar, Jx, Cx, al_gradient(Jx, Cx, rx, y_bar, axis)


def second_derivatives(Jx: Tensor, Cx: Tensor, mu: Tensor) -> AlHessian:
    """The Gauss-Newton Hessian (J, C, mu), unmaterialized."""
    return AlHessian(Jx, Cx, mu)


def new_point(x: Tensor, y: Tensor, mu: Tensor, fns, axis: Optional[str] = None
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, AlHessian]:
    """Full evaluation at x: (rx, cx, y_bar, mx, g, H).  `fns` holds the
    batched callables (`solver/api.NLSFunctions`)."""
    rx = fns.residuals(x)
    cx = fns.nlconstraints(x)
    y_bar, Jx, Cx, g = first_derivatives(x, y, mu, rx, cx, fns.jac_res, fns.jac_nlcons, axis)
    return rx, cx, y_bar, al_value(rx, cx, y, mu, axis), g, second_derivatives(Jx, Cx, mu)


def evaluate_al(x: Tensor, y: Tensor, mu: Tensor, fns, axis: Optional[str] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Value-only evaluation (no Jacobians): (rx, cx, mx)."""
    rx = fns.residuals(x)
    cx = fns.nlconstraints(x)
    return rx, cx, al_value(rx, cx, y, mu, axis)
