"""QR factorizations for the Gauss-Newton algebra (PyTorch port of
`thin_qr` and `qr_r` in `benlsip_tpu/ops/qr.py`).

Dispatch follows the JAX gate (`ops/qr.py:31-40` there): batched float32
matrices with 0 < N ≤ 16 columns and N ≤ D ≤ 2048 rows go to the
hand-written modified Gram–Schmidt kernel (`kernels/batched_linalg.py`;
its plain PyTorch version on a CPU tensor), everything else to
`torch.linalg.qr`.  The two routes differ in sign conventions (MGS gives R
a positive diagonal, Householder need not); every consumer here uses the
factors in sign-invariant combinations (RᵀR, Q·T).
"""
from __future__ import annotations

import torch

from ..kernels import batched_linalg as kern

Tensor = torch.Tensor


def _kernel_eligible(S: Tensor) -> bool:
    if S.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 dispatch of the batched linalg kernels is not ported yet")
    if S.ndim != 3:
        return False
    _, D, N = S.shape
    return 0 < N <= kern.MAX_DIM and N <= D <= kern.MAX_QR_ROWS and S.dtype == torch.float32


def thin_qr(S: Tensor):
    """Thin QR of a batch (B, D, N) -> (Q (B, D, K), R (B, K, N)), K = min(D, N)."""
    if _kernel_eligible(S):
        return kern.batched_thin_qr(S.contiguous())
    return torch.linalg.qr(S, mode="reduced")


def qr_r(S: Tensor) -> Tensor:
    """R factor only of a batch (B, D, N) -> (B, K, N): RᵀR = SᵀS."""
    if _kernel_eligible(S):
        return kern.batched_thin_qr(S.contiguous())[1]
    return torch.linalg.qr(S, mode="r")[1]
