"""Exact projection onto the polyhedron {v : Av = b, l ≤ v ≤ u} (PyTorch
port of `benlsip_tpu/ops/polyproject.py`).

The QP  min_v 1/2 ‖v - x‖²  s.t. A v = b, l ≤ v ≤ u  is solved in its dual
by a damped semismooth Newton iteration on F(λ) = A clip(x - Aᵀλ, l, u) - b
with an exact vectorized line search on the concave dual; see the JAX
module for the algorithm and the stall / cold-restart rescue.

Batched: each lane runs its own Newton iteration; the loop is a masked
state machine (`_loops.masked_while`, at most `max_iter` trips) in which a
lane stops updating once its own predicate is false — the JAX package's
`vmap` over `while_loop`.
As in the JAX module, the Newton matrix is factored by the library
Cholesky (`chol_linalg`, the JAX `_chol_xla`: bf16 in a float32 round
trip) and solved through the kernel gate (`cho_solve_lower`: the solve
kernel in float32 and bf16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._batched import full, mtv, mv, norm, sel, vdot
from .._loops import masked_while
from .cholesky import chol_linalg, cho_solve_lower
from .constraints import Polyhedron

Tensor = torch.Tensor

_K_SEC = 17  # grid points per section round of the line search


def line_search_geometry(dtype: torch.dtype):
    """(grow_pows, n_section) of the dual line search: the JAX module's
    float32 values (40, 6) for float32 and (60, 14) for every other dtype,
    bfloat16 included, as there (`jnp.float32` is the only test)."""
    return (40, 6) if dtype == torch.float32 else (60, 14)


class _NewtonCarry(NamedTuple):
    lam: Tensor
    Fnorm: Tensor
    best: Tensor       # stall-detection reference ‖F‖ (reset on restart)
    fbest: Tensor      # smallest ‖F‖ ever seen (never reset)
    lam_best: Tensor   # the dual achieving `fbest`
    stall: Tensor
    it: Tensor
    restarted: Tensor


def projection_polyhedron(
    poly: Polyhedron,
    x: Tensor,
    tol: Optional[float] = None,
    max_iter: int = 100,
    reg: Optional[float] = None,
    lam0: Optional[Tensor] = None,
    return_lam: bool = False,
    return_iters: bool = False,
    active: Optional[Tensor] = None,
):
    """Project each lane's x (B, n) onto its polyhedron.

    `lam0` (B, m) warm-starts the dual; a warm start gets one in-loop cold
    restart when it stalls.  `active` (B,) restricts the iteration to the
    lanes an enclosing loop still runs; other lanes return unspecified
    values.  Returns v, plus the final dual and the Newton iteration count
    when asked.
    """
    dtype = x.dtype
    eps = torch.finfo(dtype).eps
    if tol is None:
        tol = eps ** 0.75
    if reg is None:
        reg = eps ** 0.5
    grow_pows, n_section = line_search_geometry(dtype)

    A, b, l, u = poly
    B, m, n = A.shape
    dev = x.device
    if m == 0:
        v = torch.clamp(x, l, u)
        out = (v,)
        if return_lam:
            out += (torch.zeros((B, 0), dtype=dtype, device=dev),)
        if return_iters:
            out += (torch.zeros((B,), dtype=torch.int32, device=dev),)
        return out if len(out) > 1 else v

    eye = torch.eye(m, dtype=dtype, device=dev)
    tol_val = tol * (1 + norm(b))
    ts = 2.0 ** torch.arange(0, grow_pows + 1, device=dev).to(dtype)   # (T,)
    lin = torch.linspace(0.0, 1.0, _K_SEC, dtype=torch.float64, device=dev).to(dtype)

    def v_of(lam):
        return torch.clamp(x - mtv(A, lam), l, u)

    def F_of(lam):
        return mv(A, v_of(lam)) - b

    def q_of(lam):
        v = v_of(lam)
        return 0.5 * vdot(v - x, v - x) + vdot(lam, mv(A, v) - b)

    def cond(c: _NewtonCarry):
        return (c.Fnorm > tol_val) & (c.it < max_iter) & ((c.stall < 4) | ~c.restarted)

    fn_zero = norm(F_of(torch.zeros((B, m), dtype=dtype, device=dev)))

    def body(c: _NewtonCarry, act: Tensor) -> _NewtonCarry:
        # Cold-restart rescue: spend the first stall trigger on lam <- 0.
        do_restart = (c.stall >= 4) & ~c.restarted
        c = _NewtonCarry(
            sel(do_restart, torch.zeros_like(c.lam), c.lam),
            torch.where(do_restart, fn_zero, c.Fnorm),
            torch.where(do_restart, fn_zero, c.best),
            c.fbest, c.lam_best,
            torch.where(do_restart, 0, c.stall),
            c.it,
            c.restarted | do_restart,
        )
        lam = c.lam
        z = x - mtv(A, lam)
        inactive = (z > l) & (z < u)
        AD = A * inactive.to(dtype).unsqueeze(-2)
        K = AD @ A.mT + reg * eye
        F = F_of(lam)
        L = chol_linalg(K)
        dlam = cho_solve_lower(L, F)

        # Exact line search on the concave dual: find the root of the
        # non-increasing slope phi(t) = wᵀ clip(z0 - t·w, l, u) - dlamᵀb.
        z0 = x - mtv(A, lam)
        w = mtv(A, dlam)
        db = vdot(dlam, b)

        def phi_grid(tg):  # tg (B, T) -> (B, T)
            V = torch.clamp(
                z0.unsqueeze(1) - tg.unsqueeze(-1) * w.unsqueeze(1), l.unsqueeze(1), u.unsqueeze(1)
            )
            return (V @ w.unsqueeze(-1)).squeeze(-1) - db.unsqueeze(-1)

        ph = phi_grid(ts.expand(B, -1))
        neg = ph <= 0
        any_neg = neg.any(-1)
        first_neg = torch.argmax(neg.to(torch.int32), dim=-1)   # first index with phi ≤ 0
        t_hi = torch.where(any_neg, ts[first_neg], ts[-1])
        t_lo = torch.where(
            any_neg & (first_neg > 0), ts[torch.clamp_min(first_neg - 1, 0)], 0.0
        )
        for _ in range(n_section):
            grid = t_lo.unsqueeze(-1) + (t_hi - t_lo).unsqueeze(-1) * lin
            pos = phi_grid(grid) > 0
            idx = torch.clamp_min(pos.sum(-1) - 1, 0)
            new_lo = grid.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
            new_hi = grid.gather(-1, torch.clamp_max(idx + 1, _K_SEC - 1).unsqueeze(-1)).squeeze(-1)
            t_lo, t_hi = new_lo, torch.where(new_hi > new_lo, new_hi, t_hi)
        t_star = 0.5 * (t_lo + t_hi)
        # Monotone safeguard: accept on dual ascent or residual decrease.
        lam_try = lam + t_star.unsqueeze(-1) * dlam
        fn_try = norm(F_of(lam_try))
        accept = (q_of(lam_try) >= q_of(lam)) | (fn_try < c.Fnorm)
        lam_new = sel(accept, lam_try, lam)
        fn_new = torch.where(accept, fn_try, c.Fnorm)
        improved = fn_new < 0.7 * c.best
        record = fn_new < c.fbest
        return _NewtonCarry(
            lam_new,
            fn_new,
            torch.minimum(fn_new, c.best),
            torch.minimum(fn_new, c.fbest),
            sel(record, lam_new, c.lam_best),
            torch.where(improved, 0, c.stall + 1),
            c.it + 1,
            c.restarted,
        )

    lam_init = (
        torch.zeros((B, m), dtype=dtype, device=dev) if lam0 is None else lam0.to(dtype)
    )
    fn0 = norm(F_of(lam_init))
    zero_i = full(B, 0, fn0, torch.int32)
    c = _NewtonCarry(
        lam_init, fn0, fn0, fn0, lam_init, zero_i, zero_i,
        full(B, lam0 is None, fn0, torch.bool),
    )
    run = cond(c) if active is None else active & cond(c)
    c = masked_while(cond, body, c, run, max_iter)   # `it` caps the trips at max_iter
    lam_fin = sel(c.Fnorm <= c.fbest, c.lam, c.lam_best)
    ret = (v_of(lam_fin),)
    if return_lam:
        ret += (lam_fin,)
    if return_iters:
        ret += (c.it,)
    return ret if len(ret) > 1 else ret[0]


def criticality_measure_polyhedron(poly: Polyhedron, x: Tensor, g: Tensor) -> Tensor:
    """‖P(x - g) - x‖ per lane with P the exact polyhedral projection."""
    return norm(projection_polyhedron(poly, x - g) - x)
