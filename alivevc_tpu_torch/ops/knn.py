"""kNN feature matching, the conversion core (module/common.py:96-109):

  * cosine similarity between every source frame and every reference frame,
  * top-k most similar reference frames per source frame (ties to the
    smallest index),
  * output = mean of those k unnormalised reference rows,
  * blended with the source: ``out * (1 - alpha) + source * alpha``.

``match_features`` is the dense plain form; ``match_features_kernel`` runs
the top-k through ``kernels/knn.py`` for all windows' queries at once and
keeps the gather-mean-alpha step in plain indexing, as the JAX package
leaves it to XLA (knn_pallas.py:359-389).
"""

from __future__ import annotations

import torch

from alivevc_tpu_torch.kernels.knn import match_features as _match_flat
from alivevc_tpu_torch.kernels.knn import topk_exact


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True))


@torch.no_grad()
def match_features(source: torch.Tensor, reference: torch.Tensor, k: int = 4,
                   alpha: float = 0.0) -> torch.Tensor:
    """Dense kNN-VC replacement, channels-last.  source [N, Ls, D];
    reference [N, Lr, D] or [Lr, D] (shared across the batch)."""
    if reference.dim() == 2:
        reference = reference.expand(source.shape[0], *reference.shape)
    sims = _l2_normalize(source) @ _l2_normalize(reference).transpose(1, 2)   # [N, Ls, Lr]
    n, ls, lr = sims.shape
    _, idx = topk_exact(sims.reshape(n * ls, lr).float(), k)
    idx = idx.reshape(n, ls, k)
    gathered = reference[torch.arange(n, device=idx.device)[:, None, None], idx]   # [N, Ls, k, D]
    return gathered.mean(dim=2) * (1.0 - alpha) + source * alpha


@torch.no_grad()
def match_features_kernel(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                          alpha: float = 0.0, precision: str = "default") -> torch.Tensor:
    """source [N, Ls, D] against library [Lr, D]: one top-k over all N*Ls
    queries, then the mean of the k library rows in float32, alpha-blended.
    Returns float32 [N, Ls, D]."""
    n, ls, d = source.shape
    return _match_flat(source.reshape(n * ls, d), library, k, alpha, precision).reshape(n, ls, d)
