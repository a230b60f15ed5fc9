"""Process groups and the device mesh (``alivevc_tpu/parallel/mesh.py``).

The scale-out axes are those of the JAX package:

  * ``data``    — windows (utterance batches), data-parallel;
  * ``library`` — the voice library's frame axis, for sharded kNN retrieval
                  (``parallel/sharded_knn.py``).

One process per rank.  Nothing here reads the environment: the caller
gives ``init_distributed`` its rendezvous (``tcp://host:port`` or
``file://path``), world size and rank.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with those dimension names; its
groups use the default group's backend (NCCL across cards, gloo on the CPU
or for several ranks on one card).  Models are small and replicated.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_distributed(backend: str, init_method: str, world_size: int, rank: int) -> None:
    """Join the default process group, e.g.
    ``init_distributed('gloo', 'tcp://localhost:29500', 4, rank)``."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_mesh(axes: Sequence[Tuple[str, int]], device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default group, e.g.
    ``make_mesh([('data', 2), ('library', 2)], 'cpu')``; the product of the
    sizes must be the world size."""
    names = tuple(name for name, _ in axes)
    shape = tuple(size for _, size in axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} != world size {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@torch.no_grad()
def replicate(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank to every rank, in place; returns the module."""
    src = int(mesh.mesh.flatten()[0])
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src)
    return module


def shard_along(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, split evenly over the mesh
    axis ``axis_name`` (a view, no copy)."""
    parts = mesh.size(mesh.mesh_dim_names.index(axis_name))
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of size {size} does not split over {parts} '{axis_name}' ranks")
    step = size // parts
    return x.narrow(dim, mesh.get_local_rank(axis_name) * step, step)
