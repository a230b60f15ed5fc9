"""Library-sharded kNN retrieval (``alivevc_tpu/parallel/sharded_knn.py``).

The voice library is split over the mesh axis ``library``; each rank takes
a local top-k over its shard with the kNN kernel, then the winners are
merged in two phases:

  1. score merge — ``all_gather`` of the k (score, local index) pairs per
     shard, then an exact top-k over the shard-major [Q, P*k] candidates,
     ties to the smallest position, which is the smallest global index
     (the shard is the high-order part);
  2. vector reduce — each rank sums the library rows of the winners it
     owns, one ``all_reduce`` sums the partial sums, and /k gives the mean.

Traffic is O(Q * (P*k + D)) values, independent of the library size.
Padding is a row suffix of the last shards (``pad_library_for_sharding``),
so each shard passes its valid-row count to the kernel, in every precision
(the JAX package's exact modes use a penalty column instead, and its
``knn_topk_twopass`` drops ``valid_rows`` outside the packed mode).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from alivevc_tpu_torch.kernels.knn import knn_topk, topk_exact
from alivevc_tpu_torch.parallel.mesh import shard_along


def pad_library_for_sharding(library: torch.Tensor, num_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(library padded with zero rows to a multiple of ``num_shards``,
    valid mask [Lr_padded] bool)."""
    lr = library.shape[0]
    pad = (-lr) % num_shards
    valid = torch.arange(lr + pad, device=library.device) < lr
    if pad:
        library = torch.cat([library, library.new_zeros((pad, library.shape[1]))])
    return library, valid


def local_topk_merge(src: torch.Tensor, lib_shard: torch.Tensor, valid_shard: torch.Tensor,
                     mesh: DeviceMesh, k: int = 4, alpha: float = 0.0,
                     axis_name: str = "library", precision: str = "highest",
                     return_indices: bool = False):
    """Per-shard top-k + the two-phase merge over ``axis_name``.

    src [Q, D] (the same queries on every rank of the axis), lib_shard
    [Lr/P, D] this rank's shard, valid_shard [Lr/P] bool.  Returns the
    matched features [Q, D] float32 on every rank, and with
    ``return_indices`` also the global library indices [Q, k] (int64)."""
    group = mesh.get_group(axis_name)
    parts = dist.get_world_size(group)
    me = mesh.get_local_rank(axis_name)
    rows = lib_shard.shape[0]
    vals, idx = knn_topk(src, lib_shard, k=k, precision=precision,
                         valid_rows=valid_shard.sum())

    # phase 1: score merge over the shard-major candidates
    all_v = [torch.empty_like(vals) for _ in range(parts)]
    all_i = [torch.empty_like(idx) for _ in range(parts)]
    dist.all_gather(all_v, vals.contiguous(), group=group)
    dist.all_gather(all_i, idx.contiguous(), group=group)
    q = src.shape[0]
    flat_v = torch.stack(all_v, dim=1).reshape(q, parts * k)
    flat_i = torch.stack(all_i, dim=1).reshape(q, parts * k)
    _, pos = topk_exact(flat_v, k)
    win_shard = pos // k
    win_local = flat_i.gather(1, pos)

    # phase 2: each rank adds the rows of the winners it owns.  A shard with
    # fewer than k valid rows returns sentinel indices; they never win while
    # the library has k rows, and only owned winners are gathered.
    mine = win_shard == me
    rows_of = torch.where(mine, win_local, 0)
    vecs = lib_shard[rows_of].float()                                  # [Q, k, D]
    total = torch.where(mine[..., None], vecs, 0.0).sum(dim=1)
    dist.all_reduce(total, group=group)
    result = (total / k) * (1.0 - alpha) + src.float() * alpha
    if return_indices:
        return result, win_shard * rows + win_local
    return result


def sharded_match_features(mesh: DeviceMesh, source: torch.Tensor, library: torch.Tensor,
                           valid: torch.Tensor, k: int = 4, alpha: float = 0.0,
                           axis_name: str = "library", precision: str = "highest",
                           return_indices: bool = False):
    """``match_features`` with the library split over ``axis_name``.

    source [Ls, D] (the same on every rank), library [Lr_padded, D] and
    valid [Lr_padded] from ``pad_library_for_sharding`` (each rank keeps
    its own rows).  The result [Ls, D] float32 is the same on every rank and
    equals the single-device match on the unpadded library."""
    return local_topk_merge(source, shard_along(library, mesh, axis_name),
                            shard_along(valid, mesh, axis_name), mesh, k=k, alpha=alpha,
                            axis_name=axis_name, precision=precision,
                            return_indices=return_indices)
