"""Exact projection onto the polyhedron {v : Av = b, l ≤ v ≤ u} (PyTorch
port of `benlsip_tpu/ops/polyproject.py`).

The QP  min_v 1/2 ‖v - x‖²  s.t. A v = b, l ≤ v ≤ u  is solved in its dual
by a damped semismooth Newton iteration on F(λ) = A clip(x - Aᵀλ, l, u) - b
with an exact vectorized line search on the concave dual; see the JAX
module for the algorithm and the stall / cold-restart rescue.

Batched: each lane runs its own Newton iteration to its own exit.  Where
`newton_on_kernel` says so (a CUDA tensor in float32 or bf16 with
0 < m ≤ 16) the whole iteration is one launch of the hand-written kernel
`kernels.batched_linalg.polyhedron_newton`: no host sync, no loop node in a
captured graph.  Everything else (every CPU tensor, float64 — the
certification's pix check — and m > 16) runs `dual_newton`, the kernel's
plain version: a masked state machine (`_loops.masked_while`, at most
`max_iter` trips) in which a lane stops updating once its own predicate is
false — the JAX package's `vmap` over `while_loop`.  There, as in the JAX
module, the Newton matrix is factored by the library Cholesky
(`chol_linalg`, the JAX `_chol_xla`: bf16 in a float32 round trip) and
solved through the kernel gate (`cho_solve_lower`: the solve kernel in
float32 and bf16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._batched import full, mtv, mv, norm, sel, vdot
from .._loops import masked_while
from ..kernels import batched_linalg as kern
from .cholesky import _kernel_eligible, _row_major_blocks, chol_linalg, cho_solve_lower
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


def newton_on_kernel(device_type: str, dtype: torch.dtype, m: int, n: int) -> bool:
    """Whether a projection of (m, n) instances of `dtype` on a device of
    `device_type` runs the dual-Newton kernel: CUDA, float32 or bf16,
    0 < m ≤ 16 (the gate of `ops/cholesky._fused_eligible`), n > 0.  A gate,
    not a fallback: the kernel launches or raises."""
    return device_type == "cuda" and _kernel_eligible(m, dtype) and n > 0


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
    lanes an enclosing loop still runs; other lanes run no trip and return
    v = clip(x − Aᵀλ₀, l, u) and λ₀.  Returns v, plus the final dual and the
    Newton iteration count when asked.
    """
    dtype = x.dtype
    eps = torch.finfo(dtype).eps
    if tol is None:
        tol = eps ** 0.75
    if reg is None:
        reg = eps ** 0.5

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

    if newton_on_kernel(dev.type, dtype, m, n):
        v, lam_fin, it = kern.polyhedron_newton(
            _row_major_blocks(A), b.contiguous(), l.contiguous(), u.contiguous(),
            x.contiguous(), tol, reg, max_iter, *line_search_geometry(dtype),
            lam0=None if lam0 is None else lam0.to(dtype).contiguous(),
            active=None if active is None else active.contiguous(),
        )
    else:
        v, lam_fin, it = dual_newton(A, b, l, u, x, tol, reg, max_iter, lam0, active, *line_search_geometry(dtype))
    ret = (v,)
    if return_lam:
        ret += (lam_fin,)
    if return_iters:
        ret += (it,)
    return ret if len(ret) > 1 else ret[0]


def dual_newton(A: Tensor, b: Tensor, l: Tensor, u: Tensor, x: Tensor, tol: float, reg: float, max_iter: int,
                lam0: Optional[Tensor], active: Optional[Tensor], grow_pows: int, n_section: int):
    """The dual Newton as a masked loop of batched torch ops, m > 0: the
    plain version of the `polyhedron_newton` kernel, and the projection of
    every call outside its gate.  Returns (v, λ, trips)."""
    dtype = x.dtype
    B, m, n = A.shape
    dev = x.device
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
    return v_of(lam_fin), lam_fin, c.it


def newton_plain(A: Tensor, b: Tensor, l: Tensor, u: Tensor, x: Tensor, tol: float, reg: float, max_iter: int,
                 grow_pows: int, n_section: int, lam0: Optional[Tensor] = None, active: Optional[Tensor] = None):
    """The plain PyTorch version of the `polyhedron_newton` kernel, with its
    call signature: `dual_newton` with the given tolerances and geometry;
    in bf16 that loop in float32 on the upcast inputs, v and λ rounded
    once.  The kernel's wrapper runs it on CPU tensors."""
    if x.dtype == torch.bfloat16:
        up = [None if t is None else t.float() for t in (A, b, l, u, x, lam0)]
        v, lam, it = dual_newton(*up[:5], tol, reg, max_iter, up[5], active, grow_pows, n_section)
        return v.to(torch.bfloat16), lam.to(torch.bfloat16), it
    return dual_newton(A, b, l, u, x, tol, reg, max_iter, lam0, active, grow_pows, n_section)


kern.set_newton_plain(newton_plain)


def criticality_measure_polyhedron(poly: Polyhedron, x: Tensor, g: Tensor) -> Tensor:
    """‖P(x - g) - x‖ per lane with P the exact polyhedral projection."""
    return norm(projection_polyhedron(poly, x - g) - x)
