"""F0Estimator — per-frame pitch classifier whose bin index is the Hz value
(module/f0_estimator.py:8-43).  spec [N, T, 641] -> logits [N, T, 4096];
``f0_estimate`` is the argmax as float Hz [N, T, 1]."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alivevc_tpu_torch.config import F0EstimatorConfig
from alivevc_tpu_torch.nn.layers import ChannelNorm, ConvNeXt1d, Linear


class F0Estimator(nn.Module):
    def __init__(self, cfg: F0EstimatorConfig = F0EstimatorConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.input_layer = Linear(cfg.input_channels, cfg.internal_channels, generator)
        self.mid_layers = nn.ModuleList([
            ConvNeXt1d(cfg.internal_channels, cfg.hidden_channels, cfg.kernel_size,
                       scale=1.0 / cfg.num_layers, generator=generator)
            for _ in range(cfg.num_layers)
        ])
        self.last_norm = ChannelNorm(cfg.internal_channels)
        self.output_layer = Linear(cfg.internal_channels, cfg.output_channels, generator)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        return f0_estimator(self, spec)


def f0_estimator(m: F0Estimator, spec: torch.Tensor) -> torch.Tensor:
    """spec [N, T, n_bins] -> logits [N, T, output_channels]."""
    x = m.input_layer(spec)
    for block in m.mid_layers:
        x = block(x)
    return m.output_layer(m.last_norm(x))


@torch.no_grad()
def f0_estimate(m: F0Estimator, spec: torch.Tensor) -> torch.Tensor:
    """spec [N, T, n_bins] -> f0 in Hz [N, T, 1]: the argmax bin (the first
    of equal maxima, as jnp.argmax)."""
    logits = f0_estimator(m, spec)
    return torch.argmax(logits, dim=-1).to(spec.dtype)[..., None]
