"""Collectives of the training steps over ``torch.distributed`` (one process
per rank).  Each takes the group explicitly; ``group=None`` is this process
alone, and then each is the identity (the roll is ``torch.roll``) and no
collective runs, so one step serves one process and any number of ranks.

Each rank computes its gradients on its own slice of the batch; the only
traffic is one all-reduce of a flat bucket per model (and of the metrics),
the JAX package's ``pmean`` after a local ``value_and_grad``
(``alivevc_tpu/train/gan.py:178-248``).  The pseudo-speaker roll crosses
ranks with one ``all_gather`` of each rank's last row, since gloo is not
relied on for point-to-point CUDA tensors (``parallel/halo.py`` does the
same).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def global_roll(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``torch.roll(x, 1, 0)`` over the batch split across ranks: rank j's
    first row is rank j-1's last row (rank 0's is the last rank's)."""
    if group is None:
        return torch.roll(x, 1, 0)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    last = x[-1:].contiguous()
    rows = [torch.empty_like(last) for _ in range(world)]
    dist.all_gather(rows, last, group=group)
    return torch.cat([rows[(rank - 1) % world], x[:-1]], dim=0)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mean: bool = True,
                    group: Optional[dist.ProcessGroup] = None) -> List[torch.Tensor]:
    """Sum (or mean) of each tensor over the ranks, as one all-reduce of a
    flat bucket; returns new tensors of the same shapes."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_metrics(metrics: Dict[str, torch.Tensor],
                       group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """The mean of each scalar metric over the ranks."""
    if group is None:
        return metrics
    names = sorted(metrics)
    vals = all_reduce_flat([metrics[k].detach().float().reshape(()) for k in names], True, group)
    return dict(zip(names, vals))


def my_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """This rank's equal slice of ``x``'s first axis (all of it alone)."""
    if group is None:
        return x
    per = x.shape[0] // dist.get_world_size(group)
    rank = dist.get_rank(group)
    return x[rank * per:(rank + 1) * per]
