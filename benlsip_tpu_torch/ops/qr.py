"""QR factorizations for the Gauss-Newton algebra (PyTorch port of
`benlsip_tpu/ops/qr.py`).

Dispatch starts from the JAX gate (`ops/qr.py:31-40` there): batched
float32 and bfloat16 matrices with 0 < N ≤ 16 columns and N ≤ D ≤ 2048 rows go to the
hand-written modified Gram–Schmidt kernel (`kernels/batched_linalg.py`;
its plain PyTorch version on a CPU tensor): `batched_thin_qr` where Q is
wanted, `narrow_qr_r` (no Q written) where R alone is.  `qr_r_stacked(JZ,
dbot)` is R of [JZ; diag(dbot)], the polish's factor: inside the narrow gate
one launch of `narrow_qr_r` that makes the diagonal rows up, elsewhere
`qr_r` of the stacked matrix.  The bound N ≤ 16 is the TPU
kernel's (it unrolls N(N+1)/2 column updates over a slab held in VMEM), not
this card's: `qr_r`, which wants R only, sends float32 16 < N ≤ 256 at the
same row bound and a batch of at least 4 to the panel kernel `blocked_qr_r` (block
Gram–Schmidt, a thread-block cluster per instance that splits the rows), and
`qr_r_stacked` sends the stacked matrix of that gate to one launch of it
that makes the diagonal rows up.  256
columns, 2048 rows and 4 instances are the card's gate: where the kernel is
measured no slower than the library call, which gives every matrix the
whole card in turn and so wins on one or two large ones.
`thin_qr` keeps the narrow gate (Gram–Schmidt's Q loses orthogonality with κ
where its R does not), and everything else goes to `torch.linalg.qr`.
Neither `torch.linalg.qr` nor the panel kernel takes bfloat16: a bf16
matrix outside the narrow gate is factored in float32 and its factors
rounded back (the JAX package's `_xla_qr`), and CholeskyQR2 of a bf16
matrix computes in float32 and returns bf16 (JAX `cholqr2i_r`).  The
routes differ in sign conventions (Gram–Schmidt gives R a positive
diagonal, Householder need not); every consumer here uses the factors in
sign-invariant combinations (RᵀR, Q·T).

CholeskyQR2 (`cholqr2i_r`) builds the same R from the Gram matrix: its
(n, n) Choleskys are at n ≥ 64 in the solver, where the JAX
package goes to XLA, so they use `ops/cholesky.chol_linalg` (NaN on
failure, never an exception), not the small-matrix kernel.  Its two
rescues decide on the host in eager mode only; under CUDA-graph capture
(`batch/fused_small`) they select per lane, the explicit pass behind an
IF node.  Inputs are batched (B, d, n).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _loops
from ..kernels import batched_linalg as kern
from .cholesky import chol_linalg

Tensor = torch.Tensor
_BF16 = torch.bfloat16


def _kernel_eligible(S: Tensor, max_cols: int = kern.MAX_DIM, min_batch: int = 0,
                     dtypes: tuple = (torch.float32, _BF16), extra_rows: int = 0) -> bool:
    """Whether S (B, D, N), with `extra_rows` more rows stacked under it,
    is inside a kernel's gate."""
    if S.ndim != 3:
        return False
    B, D, N = S.shape
    return (0 < N <= max_cols and N <= D + extra_rows <= kern.MAX_QR_ROWS and B >= min_batch
            and S.dtype in dtypes)


def thin_qr(S: Tensor):
    """Thin QR of a batch (B, D, N) -> (Q (B, D, K), R (B, K, N)), K = min(D, N)."""
    if _kernel_eligible(S):
        return kern.batched_thin_qr(S.contiguous())
    if S.dtype == _BF16:
        Q, R = torch.linalg.qr(S.float(), mode="reduced")
        return Q.to(_BF16), R.to(_BF16)
    return torch.linalg.qr(S, mode="reduced")


def qr_r(S: Tensor) -> Tensor:
    """R factor only of a batch (B, D, N) -> (B, K, N): RᵀR = SᵀS."""
    if _kernel_eligible(S):
        return kern.narrow_qr_r(S.contiguous())
    if S.dtype == _BF16:
        return qr_r(S.float()).to(_BF16)
    if _kernel_eligible(S, kern.MAX_BLOCKED_QR_COLS, kern.MIN_BLOCKED_QR_BATCH, (torch.float32,)):
        return kern.blocked_qr_r(S.contiguous())
    return torch.linalg.qr(S, mode="r")[1]


def qr_r_stacked(JZ: Tensor, dbot: Tensor) -> Tensor:
    """R factor of the stacked [JZ; diag(dbot)], JZ (B, d, n), dbot (B, n)
    -> (B, n, n): one launch of the narrow kernel inside its gate, or of the
    panel kernel inside `qr_r`'s panel gate, either making the diagonal rows
    up (the same bits as the kernel on the stacked matrix); `qr_r` of the
    stacked matrix elsewhere."""
    n = JZ.shape[-1]
    if _kernel_eligible(JZ, extra_rows=n):
        return kern.narrow_qr_r(JZ.contiguous(), dbot.contiguous())
    if _kernel_eligible(JZ, kern.MAX_BLOCKED_QR_COLS, kern.MIN_BLOCKED_QR_BATCH, (torch.float32,), extra_rows=n):
        return kern.blocked_qr_r(JZ.contiguous(), dbot.contiguous())
    return qr_r(torch.cat([JZ, torch.diag_embed(dbot)], dim=-2))


def _chol_upper(G: Tensor) -> Tensor:
    """Upper-triangular R with RᵀR = G (transpose of the lower Cholesky);
    all-NaN in a lane whose G is not positive definite."""
    return chol_linalg(G).mT


def _nan_lanes(R: Tensor) -> Tensor:
    return torch.isnan(R).any(-1, keepdim=True).any(-2, keepdim=True)


def _rescued_chol_upper(G: Tensor) -> Tensor:
    """Cholesky of a Gram matrix with the shift rescue for κ(S) ≳ 1/√eps:
    a lane whose factor breaks down is refactored as G + σI with
    σ = 2 n eps tr(G).  The shift perturbs only the conditioning of the
    CholeskyQR2 transforms, never the final product R₂R₁ (see the JAX
    function).  In eager mode the host asks whether a lane needs the
    shifted factor (one counted sync, `_loops.host_any`), and it is
    computed only then; under CUDA-graph capture
    and in "all_trips" (`_loops`) it is computed for every lane and selected
    per lane (one more batched Cholesky, no host decision): the same bits
    in every lane, since both routes factor the whole batch."""
    n = G.shape[-1]
    R = _chol_upper(G)
    bad = _nan_lanes(R)
    if _loops.current_mode() == "eager" and not _loops.host_any(bad):
        return R
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    sigma = 2.0 * n * torch.finfo(G.dtype).eps * tr
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    return torch.where(bad, _chol_upper(G + sigma * eye), R)


def _explicit_r2(S: Tensor, R1: Tensor) -> Tensor:
    """Explicit second pass: W = S R₁⁻¹, R₂ = chol(WᵀW) (a Gram, PSD at any κ)."""
    W = torch.linalg.solve_triangular(R1, S, upper=True, left=False)
    return _rescued_chol_upper(W.mT @ W)


def _implicit_refine_r2(G: Tensor, R1: Tensor):
    """Implicit second-pass factor from the formed Gram:
    R₂ = chol(R₁⁻ᵀ G R₁⁻¹).  Returns (R₂, bad): a lane whose refinement
    Cholesky broke down gets R₂ = I (R = R₁) and is flagged in `bad` (B, 1, 1)."""
    T = torch.linalg.solve_triangular(R1.mT, G, upper=False)
    G2 = torch.linalg.solve_triangular(R1, T, upper=True, left=False)
    G2 = 0.5 * (G2 + G2.mT)
    R2 = _chol_upper(G2)
    bad = _nan_lanes(R2)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return torch.where(bad, eye, R2), bad


def implicit_refine_upper(G: Tensor, R1: Tensor) -> Tensor:
    """R with RᵀR = G from the formed Gram and its first factor R₁, with no
    pass over S: R₂R₁ from the implicit refinement, R₁ in a lane whose
    refinement broke down (the row-sharded operator's route, where the
    explicit pass would need a second psum)."""
    return _implicit_refine_r2(G, R1)[0] @ R1


def rescue_broken_refinement(R2: Tensor, bad: Tensor, S: Tensor, R1: Tensor) -> Tensor:
    """Replace R₂ by the explicit pass on S in the lanes flagged `bad` (B, 1, 1)
    only; healthy lanes keep their implicit factor bit for bit (the JAX
    `lax.cond` under `vmap`, a per-instance select).

    In eager mode the host gathers the flagged lanes (one counted sync,
    `_loops.host_nonzero`) and runs the explicit pass on them alone, and
    skips it when no lane is bad.  Under CUDA-graph
    capture and in "all_trips" (`_loops`) the pass runs on every lane inside
    `_loops.branch_any(bad)` (an IF node under capture: a replay runs it
    only when a lane is bad) and the flagged lanes are selected.  A rescued
    lane may then differ from the eager gather in the last bits, where the
    batched library calls choose their algorithm by batch size."""
    if _loops.current_mode() != "eager":
        return _loops.branch_any(bad.reshape(-1), lambda: torch.where(bad, _explicit_r2(S, R1), R2), R2)
    lanes = _loops.host_nonzero(bad.reshape(-1)).to(R2.device)
    if lanes.numel() == 0:
        return R2
    R2 = R2.clone()
    R2[lanes] = _explicit_r2(S[lanes], R1[lanes])
    return R2


def cholqr2i_r(S: Tensor, G: Optional[Tensor] = None) -> Tensor:
    """R factor of S (B, d, n) via CholeskyQR2 with the implicit refinement
    pass from the Gram G = SᵀS (formed here unless given): R₁ = chol(G),
    R₂ = chol(R₁⁻ᵀ G R₁⁻¹), R = R₂R₁.  A lane whose implicit refinement
    breaks down (κ(S)²·eps ≳ 1) is rescued through the explicit pass on S.
    A bf16 S (and G) is computed with in float32; R comes back in S's dtype."""
    if S.dtype == _BF16:
        return cholqr2i_r(S.float(), None if G is None else G.float()).to(_BF16)
    if G is None:
        G = S.mT @ S
    R1 = _rescued_chol_upper(G)
    R2, bad = _implicit_refine_r2(G, R1)
    return rescue_broken_refinement(R2, bad, S, R1) @ R1
