"""VoiceLibrary: the target speaker's 512-token embedding bank
(module/voice_library.py:6-33), inference half.

The tokens keep the reference's layout, ``tokens`` [1, 768, num_tokens], so
a reference ``.pt`` loads with strict key matching; ``matrix`` gives the
[num_tokens, 768] rows that ``build_target_matrix`` appends to the target
matrix (the JAX package transposes on import,
``alivevc_tpu/compat/torch_import.py:138-139``).  The differentiable match
that trains the tokens comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alivevc_tpu_torch.config import VoiceLibraryConfig


class VoiceLibrary(nn.Module):
    def __init__(self, cfg: VoiceLibraryConfig = VoiceLibraryConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Gaussian init, as torch.randn (module/voice_library.py:9)
        self.tokens = nn.Parameter(torch.randn(1, cfg.dim, cfg.num_tokens, generator=generator))

    def matrix(self) -> torch.Tensor:
        """The tokens as library rows, [num_tokens, dim]."""
        return self.tokens[0].t()
