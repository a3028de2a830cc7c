"""Small helpers for batch-first tensors.

Every state tensor of the port carries a leading batch axis B: vectors are
(B, n), matrices (B, m, n), per-lane scalars (B,).  The JAX package writes
the same algebra for one instance and lifts it with `vmap`; these helpers
are the batched forms of its matvecs, dot products and selects.
"""
from __future__ import annotations

from typing import NamedTuple, TypeVar

import torch

Tensor = torch.Tensor
T = TypeVar("T", bound=NamedTuple)


def mv(A: Tensor, v: Tensor) -> Tensor:
    """Batched A @ v: (B, m, n), (B, n) -> (B, m)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def mtv(A: Tensor, v: Tensor) -> Tensor:
    """Batched Aᵀ @ v: (B, m, n), (B, m) -> (B, n)."""
    return (A.mT @ v.unsqueeze(-1)).squeeze(-1)


def vdot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane dot product over the last axis."""
    return (a * b).sum(-1)


def norm(a: Tensor) -> Tensor:
    """Per-lane Euclidean norm over the last axis."""
    return torch.linalg.vector_norm(a, dim=-1)


def sel(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """torch.where with a per-lane (B,) mask broadcast over trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def sel_tuple(mask: Tensor, new: T, old: T) -> T:
    """Per-lane select of every field of two NamedTuples; nested
    NamedTuples are selected field by field and None fields stay None."""
    return type(old)(*[
        o if o is None else sel_tuple(mask, n, o) if isinstance(o, tuple) else sel(mask, n, o)
        for n, o in zip(new, old)
    ])


def tree_map(fn, tree):
    """Apply fn to every tensor of problem data theta (a tensor or a dict
    of them, nested)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def full(B: int, value, like: Tensor, dtype=None) -> Tensor:
    """(B,) tensor filled with `value` on `like`'s device (dtype defaults to like's)."""
    return torch.full((B,), value, dtype=dtype or like.dtype, device=like.device)
