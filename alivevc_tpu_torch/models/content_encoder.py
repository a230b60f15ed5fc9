"""ContentEncoder — ConvNeXt-1d stack distilled from WavLM
(module/content_encoder.py:8-25).  spec [N, T, 641] -> content [N, T, 768]."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alivevc_tpu_torch.config import ContentEncoderConfig
from alivevc_tpu_torch.nn.layers import ConvNeXt1d, Linear


class ContentEncoder(nn.Module):
    def __init__(self, cfg: ContentEncoderConfig = ContentEncoderConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.input_layer = Linear(cfg.input_channels, cfg.internal_channels, generator)
        self.mid_layers = nn.ModuleList([
            ConvNeXt1d(cfg.internal_channels, cfg.hidden_channels, cfg.kernel_size,
                       scale=1.0 / cfg.num_layers, generator=generator)
            for _ in range(cfg.num_layers)
        ])
        self.output_layer = Linear(cfg.internal_channels, cfg.output_channels, generator)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        return content_encoder(self, spec)


def content_encoder(m: ContentEncoder, spec: torch.Tensor) -> torch.Tensor:
    """spec [N, T, n_bins] -> content [N, T, output_channels]."""
    x = m.input_layer(spec)
    for block in m.mid_layers:
        x = block(x)
    return m.output_layer(x)
