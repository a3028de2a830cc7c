"""Cholesky factorizations for masked active-set projections (PyTorch port
of `benlsip_tpu/ops/cholesky.py`).

The active-set projections factor the fixed-size m×m matrix A Z Aᵀ,
Z = diag(free) — see the JAX module for the equivalence with the
reference's augmented ÃÃᵀ factorization.  Dispatch follows the JAX gate
(`ops/cholesky.py:44-45,88,112` there): batched float32 factors with
0 < M ≤ 16 go to the hand-written kernels (`kernels/batched_linalg.py`;
on a CPU tensor the kernel wrapper runs its plain PyTorch version), and
everything else — float64, larger M — goes to `torch.linalg`, exactly
where the JAX package goes to XLA.
"""
from __future__ import annotations

import torch

from ..kernels import batched_linalg as kern

Tensor = torch.Tensor

_KERNEL_MAX_M = kern.MAX_DIM


def _kernel_eligible(M: int, dtype: torch.dtype) -> bool:
    if dtype == torch.bfloat16:
        raise NotImplementedError("bf16 dispatch of the batched linalg kernels is not ported yet")
    return 0 < M <= _KERNEL_MAX_M and dtype == torch.float32


def chol_linalg(K: Tensor) -> Tensor:
    """torch.linalg Cholesky with LAPACK's failure signal: a factor whose
    matrix is not positive definite comes back as all-NaN (what
    `jnp.linalg.cholesky` returns), never as an exception."""
    if K.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 dispatch of the batched linalg kernels is not ported yet")
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cholesky(K: Tensor) -> Tensor:
    """Lower Cholesky factor of a batch of SPD matrices K (B, M, M)."""
    if K.ndim == 3 and _kernel_eligible(K.shape[-1], K.dtype):
        return kern.batched_cholesky(K.contiguous())
    return chol_linalg(K)


def _tri_solve_pair(L: Tensor, b: Tensor) -> Tensor:
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def masked_aat(A: Tensor, free: Tensor) -> Tensor:
    """A Z Aᵀ with Z = diag(free): (B, m, n), (B, n) -> (B, m, m)."""
    Af = A * free.to(A.dtype).unsqueeze(-2)
    return Af @ A.mT


def factor_masked_aat(A: Tensor, free: Tensor, reg: float = 0.0) -> Tensor:
    """Lower Cholesky factor of A Z Aᵀ (+ reg·I), batched."""
    B, m, _ = A.shape
    if m == 0:
        return torch.zeros((B, 0, 0), dtype=A.dtype, device=A.device)
    K = masked_aat(A, free)
    if reg:
        K = K + reg * torch.eye(m, dtype=A.dtype, device=A.device)
    return cholesky(K)


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
