"""Cholesky factorizations for masked active-set projections (PyTorch port
of `benlsip_tpu/ops/cholesky.py`).

The active-set projections factor the fixed-size m×m matrix A Z Aᵀ,
Z = diag(free) — see the JAX module for the equivalence with the
reference's augmented ÃÃᵀ factorization.  Dispatch follows the JAX gate
(`ops/cholesky.py:44-45,88,112` there): batched float32 and bfloat16
factors with 0 < M ≤ 16 go to the hand-written kernels
(`kernels/batched_linalg.py`; on a CPU tensor the kernel wrapper runs its
plain PyTorch version), and everything else — float64, larger M — goes to
`torch.linalg`, exactly where the JAX package goes to XLA.  `torch.linalg`
has no bfloat16 factorization or triangular solve on either device, so a
bf16 operand there is factored or solved in float32 and rounded back, as
the JAX package's `_chol_xla` / `_tri_solve_xla` do.

Eager PyTorch fuses nothing around a kernel, so the two call sites of the
active-set machinery are kernels as a whole: `factor_masked_aat` /
`factor_unfixed_aat` (mask, A Z Aᵀ, jitter, Cholesky) and
`masked_projection` (mask, A Z r, solve, Aᵀw, mask, subtract) each take
one launch for an eligible batch, and read a batch-shared A (a stride-0
expand) in place.
"""
from __future__ import annotations

import numpy as np
import torch

from .._batched import mtv, mv
from ..kernels import batched_linalg as kern

Tensor = torch.Tensor

_KERNEL_MAX_M = kern.MAX_DIM


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_eligible(M: int, dtype: torch.dtype) -> bool:
    return 0 < M <= _KERNEL_MAX_M and dtype in _KERNEL_DTYPES


def chol_linalg(K: Tensor) -> Tensor:
    """torch.linalg Cholesky with LAPACK's failure signal: a factor whose
    matrix is not positive definite comes back as all-NaN (what
    `jnp.linalg.cholesky` returns), never as an exception.  bf16 factors
    in float32 and rounds back (the JAX `_chol_xla`)."""
    if K.dtype == torch.bfloat16:
        return chol_linalg(K.float()).to(K.dtype)
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cholesky(K: Tensor) -> Tensor:
    """Lower Cholesky factor of a batch of SPD matrices K (B, M, M)."""
    if K.ndim == 3 and _kernel_eligible(K.shape[-1], K.dtype):
        return kern.batched_cholesky(K.contiguous())
    return chol_linalg(K)


def solve_triangular(R: Tensor, b: Tensor, upper: bool, left: bool = True) -> Tensor:
    """`torch.linalg.solve_triangular`; bf16 solves in float32 and rounds
    back (the JAX `_tri_solve_xla`)."""
    if R.dtype == torch.bfloat16:
        return torch.linalg.solve_triangular(R.float(), b.float(), upper=upper, left=left).to(R.dtype)
    return torch.linalg.solve_triangular(R, b, upper=upper, left=left)


def _tri_solve_pair(L: Tensor, b: Tensor) -> Tensor:
    y = solve_triangular(L, b, upper=False)
    return solve_triangular(L.mT, y, upper=True)


# A Z Aᵀ under the JAX package's ops/cholesky name.
masked_aat = kern.masked_aat


def _fused_eligible(A: Tensor) -> bool:
    """Whether the call sites on A (B, m, n) go to the fused kernels."""
    return A.ndim == 3 and _kernel_eligible(A.shape[-2], A.dtype) and A.shape[-1] > 0


def _row_major_blocks(A: Tensor) -> Tensor:
    """A as the fused kernels read it; a batch-shared A stays a stride-0 view."""
    return A if kern.has_row_major_blocks(A) else A.contiguous()


def factor_unfixed_aat(A: Tensor, fixed: Tensor, reg: float = 0.0) -> Tensor:
    """Lower Cholesky factor of A Z Aᵀ (+ reg·I), Z = diag(¬fixed), batched:
    the active set's own mask, so no launch is spent on a negation."""
    B, m, _ = A.shape
    if m == 0:
        return torch.zeros((B, 0, 0), dtype=A.dtype, device=A.device)
    if _fused_eligible(A):
        return kern.masked_aat_cholesky(_row_major_blocks(A), fixed.contiguous(), reg)
    K = masked_aat(A, ~fixed)
    if reg:
        K = K + reg * torch.eye(m, dtype=A.dtype, device=A.device)
    return cholesky(K)


def factor_masked_aat(A: Tensor, free: Tensor, reg: float = 0.0) -> Tensor:
    """Lower Cholesky factor of A Z Aᵀ (+ reg·I), Z = diag(free), batched
    (the JAX package's signature)."""
    return factor_unfixed_aat(A, ~free, reg)


def cho_solve_lower(L: Tensor, b: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = b given the lower factor L (B, M, M).

    Vector right-hand sides b (B, M) go through the kernel gate (the JAX
    package's `_cho_solve_small` custom-vmap rule); matrix right-hand
    sides (B, M, K) take the pair of triangular solves.
    """
    if b.ndim == 2:
        if _kernel_eligible(L.shape[-1], L.dtype):
            return kern.batched_cho_solve(L.contiguous(), b.contiguous())
        return _tri_solve_pair(L, b.unsqueeze(-1)).squeeze(-1)
    return _tri_solve_pair(L, b)


def masked_projection(A: Tensor, L: Tensor, fixed: Tensor, r: Tensor, unmasked_output: bool = False) -> Tensor:
    """Z r − Z Aᵀ w with w = (L Lᵀ)⁻¹ A Z r and Z = diag(¬fixed), m > 0;
    with `unmasked_output`, r − Aᵀ w for the same w (the projection
    multipliers of the coupled binding test)."""
    if _fused_eligible(A):
        return kern.project_tangent(
            _row_major_blocks(A), L.contiguous(), fixed.contiguous(), r.contiguous(), unmasked_output
        )
    free = ~fixed
    rz = torch.where(free, r, 0.0)
    w = cho_solve_lower(L, mv(A, rz))
    if unmasked_output:
        return r - mtv(A, w)
    return rz - torch.where(free, mtv(A, w), 0.0)


def cholesky_aug_aat_dense(A: np.ndarray, fixed: np.ndarray, L_aat: np.ndarray) -> np.ndarray:
    """The reference's blocked augmented factorization on the host (numpy
    in and out, one instance; for parity tests): given L_aat = chol(AAᵀ),
    the lower factor of ÃÃᵀ, Ã = [A; e_iᵀ for i fixed], through
    G = L_aat⁻¹ A[:, fixed] and the Schur block chol(I − GᵀG)."""
    A = np.asarray(A)
    fixed = np.asarray(fixed, dtype=bool)
    m = A.shape[0]
    p = int(fixed.sum())
    L = np.zeros((m + p, m + p), dtype=A.dtype)
    G = np.linalg.solve(L_aat, A[:, fixed]) if p else np.zeros((m, 0), dtype=A.dtype)
    L[:m, :m] = L_aat
    L[m:, :m] = G.T
    if p:
        L[m:, m:] = np.linalg.cholesky(np.eye(p, dtype=A.dtype) - G.T @ G)
    return L
