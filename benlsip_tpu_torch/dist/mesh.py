"""Device mesh and the slices each rank holds (PyTorch port of
`benlsip_tpu/dist/mesh.py`).

Two mesh dims cover the two execution regimes:

* `batch` — data parallelism over independent NLS instances: each rank
  solves its slice of the batch with no communication in the loop;
* `block` — row parallelism inside one large instance (BASELINE config 4):
  each rank holds a block of Jacobian / residual rows, and every contraction
  over the residual dimension carries an explicit all-reduce
  (`dist/collectives.py`, `SolverOptions.spmd_axis`).

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names=("batch", "block")` over the ranks of the default process
group.  torch has no SPMD partitioner, so where the JAX module returns a
`NamedSharding` for XLA to place an array with, the helpers here return
this rank's slice of the array.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._batched import tree_map

Tensor = torch.Tensor

MESH_DIMS = ("batch", "block")


def make_mesh(batch: Optional[int] = None, block: int = 1, device: str = "cuda") -> DeviceMesh:
    """A ('batch', 'block') mesh over the ranks of the default process group.

    `batch` defaults to world_size // block.  `device` is the mesh's device
    type: "cuda" (the default; raises where there is no card) or "cpu".
    When no process group exists and the mesh is one rank, a one-rank
    group is initialized here (NCCL on the card, gloo on the CPU, over an
    in-memory store), so `make_mesh(1, 1)` needs no launcher; a mesh of
    more ranks needs the group first (`torchrun`, or
    `collectives.initialize_distributed`).
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device='cuda' and this machine has no CUDA card; pass device='cpu'")
    if not dist.is_initialized():
        if (batch or 1) * block != 1:
            raise RuntimeError(
                f"make_mesh({batch}, {block}): a mesh of several ranks needs a process group; "
                "start the ranks with torchrun or call collectives.initialize_distributed first"
            )
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1
        )
    world = dist.get_world_size()
    if batch is None:
        batch = world // block
    if batch * block != world:
        raise ValueError(f"mesh {batch}x{block} != {world} ranks")
    return init_device_mesh(device, (batch, block), mesh_dim_names=MESH_DIMS)


def dim_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh dim `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _rank_slice(mesh: DeviceMesh, axis: str, a: Tensor, dim: int) -> Tensor:
    """This rank's contiguous slice of `a` along `dim` over mesh dim `axis`."""
    size = dim_size(mesh, axis)
    if size == 1:
        return a
    rows = a.shape[dim]
    if rows % size:
        raise ValueError(f"axis {dim} of length {rows} not divisible by mesh dim {axis!r} of size {size}")
    per = rows // size
    return a.narrow(dim, mesh.get_local_rank(axis) * per, per)


def batch_sharding(mesh: DeviceMesh, a: Tensor, dim: int = 0) -> Tensor:
    """This rank's slice of the batch axis `dim` of `a` (a view)."""
    return _rank_slice(mesh, "batch", a, dim)


def block_rows_sharding(mesh: DeviceMesh, a: Tensor, dim: int = 0) -> Tensor:
    """This rank's block of the row (residual) axis `dim` of `a` (a view)."""
    return _rank_slice(mesh, "block", a, dim)


def replicated(mesh: DeviceMesh, a: Tensor) -> Tensor:
    """Every rank holds all of `a`."""
    return a


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's slice of the leading batch axis of every tensor in `tree`."""
    return tree_map(lambda a: batch_sharding(mesh, a), tree)
