"""Mesh-aware collectives on torch.distributed (PyTorch port of
`benlsip_tpu/dist/collectives.py`).

An axis is named by its mesh dim ("batch" or "block"), as in JAX, and
resolved against the mesh bound with `bind_mesh` (the JAX `shard_map`
context): the collective runs on that dim's process group.  On an axis of
size 1 every collective is the identity and launches nothing.  Each
collective is synchronous and raises when it fails.

    JAX (lax)            here (torch.distributed)
    psum / pmean         all_reduce (sum; / size)
    all_gather           all_gather_into_tensor
    psum_scatter         reduce_scatter_tensor
    ppermute (ring)      batch_isend_irecv
    axis_index / size    the rank / size in the mesh dim's group
    jax.distributed      init_process_group

The solver reaches them through `SolverOptions.spmd_axis`: `psum` for
every contraction over the residual dimension, `psum_scatter` /
`ring_psum_scatter_lazy` and `all_gather` for the row-sharded Gram layout
(`ops/al.with_gram_rows`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import dim_size

Tensor = torch.Tensor

_MESHES: list = []

# torch renamed the tensor forms of the two collectives (same arguments).
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@contextlib.contextmanager
def bind_mesh(mesh):
    """Resolve axis names against `mesh` inside the block."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def _mesh(axis: str):
    if not _MESHES:
        raise RuntimeError(f"collective on axis {axis!r} outside bind_mesh: no mesh names it")
    mesh = _MESHES[-1]
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {axis!r} is not a dim of the bound mesh {mesh.mesh_dim_names}")
    return mesh


def axis_size(axis: str) -> int:
    return dim_size(_mesh(axis), axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate along the mesh dim `axis`."""
    return _mesh(axis).get_local_rank(axis)


def _group(axis: str):
    return _mesh(axis).get_group(axis)


def psum(x: Tensor, axis: str) -> Tensor:
    """Sum across a mesh axis (CG inner products, Jᵀr, JᵀJ)."""
    if axis_size(axis) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_group(axis))
    return out


def pmean(x: Tensor, axis: str) -> Tensor:
    return psum(x, axis) / axis_size(axis)


def all_gather(x: Tensor, axis: str, *, dim: int = 0, tiled: bool = True) -> Tensor:
    """Gather the shards of every rank along `dim`, in rank order: tiled
    concatenates them, untiled stacks them on a new axis `dim`."""
    D = axis_size(axis)
    dim = dim % (x.ndim + (0 if tiled else 1))
    if D == 1:
        return x if tiled else x.unsqueeze(dim)
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), axis, dim=dim, tiled=tiled).bool()
    if tiled:
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((D * xs.shape[0],) + xs.shape[1:])
        _all_gather_into(out, xs, group=_group(axis))
        return out.movedim(0, dim)
    out = x.new_empty((D * x.numel(),))
    _all_gather_into(out, x.contiguous().reshape(-1), group=_group(axis))
    return out.reshape((D,) + x.shape).movedim(0, dim)


def psum_scatter(x: Tensor, axis: str, *, dim: int = 0, tiled: bool = True) -> Tensor:
    """Reduce-scatter: rank i keeps rows [i·k/D, (i+1)·k/D) along `dim`
    (length k) of the sum over the axis (untiled: k = D and the dim goes)."""
    D = axis_size(axis)
    dim = dim % x.ndim
    if D == 1:
        return x if tiled else x.squeeze(dim)
    if x.shape[dim] % D or (not tiled and x.shape[dim] != D):
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not scatter over {D} ranks")
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // D,) + xs.shape[1:])
    _reduce_scatter_into(out, xs, group=_group(axis))
    out = out.movedim(0, dim)
    return out if tiled else out.squeeze(dim)


def ppermute_ring(x: Tensor, axis: str, shift: int = 1) -> Tensor:
    """Ring shift along a mesh axis: rank i's x arrives at rank i + shift."""
    D = axis_size(axis)
    if shift % D == 0:
        return x
    group = _group(axis)
    i = axis_index(axis)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, (i + shift) % D), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (i - shift) % D), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_psum_scatter(x: Tensor, axis: str, *, dim: int = 0) -> Tensor:
    """`psum_scatter(x, axis, dim=dim)` built from D−1 ring hops, each moving
    one (k/D, …) chunk one step round the ring while the receiver adds its
    own contribution: per-rank wire traffic (D−1)/D of x, half an
    all-reduce's.  At step t rank j sends the partial sum of chunk
    (j−1−t) mod D; after D−1 hops chunk j rests, fully reduced, at rank j."""
    D = axis_size(axis)
    if x.shape[dim] % D:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} not divisible by ring size {D}")
    rows = x.shape[dim] // D
    return ring_psum_scatter_lazy(lambda c, _: x.narrow(dim, c * rows, rows), axis)


def ring_psum_scatter_lazy(make_chunk: Callable, axis: str, operand: Optional[Tensor] = None) -> Tensor:
    """Ring reduce-scatter whose local contributions are built when the ring
    needs them: `make_chunk(c, operand)` makes this rank's contribution to
    chunk c, so the full local partial never exists (two chunks live at a
    time: the travelling buffer and the new contribution).  Eager torch
    runs the hops in program order, so each chunk is built after the hop
    before it (the JAX version needs a `fori_loop` for that)."""
    D = axis_size(axis)
    idx = axis_index(axis)
    buf = make_chunk((idx - 1) % D, operand)
    for t in range(D - 1):
        buf = ppermute_ring(buf, axis, 1)
        buf = buf + make_chunk((idx - 2 - t) % D, operand)
    return buf


def initialize_distributed(backend: Optional[str] = None, **kwargs) -> None:
    """`torch.distributed.init_process_group`: NCCL where there is a card,
    gloo otherwise, unless `backend` names one; the rank, world size and a
    store or init_method come in `kwargs` (torchrun sets them in the
    environment)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, **kwargs)
