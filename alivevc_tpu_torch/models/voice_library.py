"""VoiceLibrary: the target speaker's 512-token embedding bank
(module/voice_library.py:6-33), inference half.

The tokens keep the reference's layout, ``tokens`` [1, 768, num_tokens], so
a reference ``.pt`` loads with strict key matching; ``matrix`` gives the
[num_tokens, 768] rows that ``build_target_matrix`` appends to the target
matrix (the JAX package transposes on import,
``alivevc_tpu/compat/torch_import.py:138-139``).

``voice_library_match`` is the differentiable match that fine-tuning trains
the tokens through (module/voice_library.py:15-33; SURVEY §2.4.6): the
top-k indices come from ``kernels/knn.py:knn_topk`` in 'highest' (exact
float32 ranking: the kernel on the card, one launch over all N * Ls
queries; the plain top-k on the CPU), on detached operands since indices
carry no gradient, and the mean of the gathered token rows carries the
gradient into the tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alivevc_tpu_torch.config import VoiceLibraryConfig
from alivevc_tpu_torch.kernels.knn import knn_topk


class VoiceLibrary(nn.Module):
    def __init__(self, cfg: VoiceLibraryConfig = VoiceLibraryConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        # Gaussian init, as torch.randn (module/voice_library.py:9)
        self.tokens = nn.Parameter(torch.randn(1, cfg.dim, cfg.num_tokens, generator=generator))

    def matrix(self) -> torch.Tensor:
        """The tokens as library rows, [num_tokens, dim]."""
        return self.tokens[0].t()


def voice_library_match(vl: VoiceLibrary, source: torch.Tensor, k: int = 4,
                        alpha: float = 0.0) -> torch.Tensor:
    """source [N, Ls, D] -> matched [N, Ls, D] float32: the mean of the k
    nearest tokens (cosine), alpha-blended with the source; the gradient
    flows into the tokens (``alivevc_tpu/models/voice_library.py``)."""
    tokens = vl.matrix()
    n, ls, d = source.shape
    flat = source.reshape(n * ls, d)
    _, idx = knn_topk(flat.detach(), tokens.detach(), k=k, precision="highest")
    matched = tokens[idx].float().mean(dim=1)
    return (matched * (1.0 - alpha) + flat.float() * alpha).reshape(n, ls, d)
