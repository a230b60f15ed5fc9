"""NN building blocks: ``nn.Module``s holding the reference's parameters
under the reference's state-dict names and layouts, and the channels-last
functions that compute with them.

Activations are ``[N, T, C]`` as in the JAX package.  Parameters keep the
PyTorch reference layout (module/common.py:14-92), so a reference
``state_dict`` or the output of ``compat/weights.py`` loads with
``load_state_dict(strict=True)``:

  * pointwise conv / linear: ``weight`` [Cout, Cin, 1], ``bias`` [Cout]
  * conv:                    ``weight`` [Cout, Cin, k]
  * depthwise conv:          ``weight`` [C, 1, k]
  * transposed conv:         ``weight`` [Cin, Cout, k]
  * ChannelNorm:             ``scale``, ``shift`` [1, C, 1]

Semantics follow the reference blocks: ChannelNorm normalises over channels
with an unbiased std and adds eps to sigma; ConvNeXt1d is depthwise k=7 ->
norm -> pw C->H -> exact GELU -> pw H->C -> per-channel scale -> + residual;
CausalConv1d left-pads with reflection.

Initialisation reproduces torch Conv1d defaults (U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, fan_in: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-based GELU (torch F.gelu default)."""
    return F.gelu(x)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pointwise conv: x [..., Cin] with weight [Cout, Cin, 1] -> [..., Cout]."""
    y = x @ weight[:, :, 0].t()
    if bias is not None:
        y = y + bias
    return y


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1-D conv, channels-last: x [N, T, Cin], weight [Cout, Cin/groups, k]."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Depthwise conv: x [N, T, C], weight [C, 1, k]."""
    return conv1d(x, weight, bias, padding=padding, dilation=dilation, groups=x.shape[-1])


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """Same-padding helper (module/common.py:10-11)."""
    return int((kernel_size * dilation - dilation) / 2)


def _norm_stats(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Channel-axis mean and unbiased std (+eps on sigma), torch semantics."""
    c = x.shape[-1]
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    var = (d * d).sum(dim=-1, keepdim=True) / (c - 1)
    return d / (torch.sqrt(var) + eps)


def causal_conv1d(conv: "Conv", x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """CausalConv1d (module/common.py:85-92): left reflect-pad, then conv."""
    k = conv.weight.shape[-1]
    pad = k * dilation - dilation
    if pad:
        x = torch.cat([x[:, 1:pad + 1].flip(1), x], dim=1)
    return conv1d(x, conv.weight, conv.bias, dilation=dilation)


def channel_norm(p: "ChannelNorm", x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """ChannelNorm (module/common.py:14-26).  x [N, T, C]."""
    return _norm_stats(x, eps) * p.scale.reshape(-1) + p.shift.reshape(-1)


def adaptive_channel_norm(p: "AdaptiveChannelNorm", x: torch.Tensor, cond: torch.Tensor,
                          eps: float = 1e-4) -> torch.Tensor:
    """AdaptiveChannelNorm (module/common.py:29-41): scale/shift from cond."""
    return _norm_stats(x, eps) * p.scale(cond) + p.shift(cond)


def convnext1d(p: "ConvNeXt1d", x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt1d block (module/common.py:45-62).  x [N, T, C]."""
    k = p.dw_conv.weight.shape[-1]
    h = depthwise_conv1d(x, p.dw_conv.weight, p.dw_conv.bias, padding=get_padding(k))
    h = channel_norm(p.norm, h)
    h = gelu(p.pw_conv1(h))
    h = p.pw_conv2(h)
    return h * p.scale.reshape(-1) + x


def adaptive_convnext1d(p: "AdaptiveConvNeXt1d", x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """AdaptiveConvNeXt1d block (module/common.py:65-82)."""
    k = p.dw_conv.weight.shape[-1]
    h = depthwise_conv1d(x, p.dw_conv.weight, p.dw_conv.bias, padding=get_padding(k))
    h = adaptive_channel_norm(p.norm, h, cond)
    h = gelu(p.pw_conv1(h))
    h = p.pw_conv2(h)
    return h * p.scale.reshape(-1) + x


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """Pointwise Conv1d(cin, cout, 1), applied over the last axis."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((cout, cin, 1), cin, generator)
        self.bias = _uniform((cout,), cin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Conv1d parameters (cin, cout, k); see ``conv1d`` / ``causal_conv1d``."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = (cin // groups) * k
        self.weight = _uniform((cout, cin // groups, k), fan_in, generator)
        self.bias = _uniform((cout,), fan_in, generator)


class ConvTranspose(nn.Module):
    """ConvTranspose1d(cin, cout, k, stride=k) parameters: weight [cin, cout, k]."""

    def __init__(self, cin: int, cout: int, k: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        # torch's fan_in for a transposed conv is out_channels * k
        self.weight = _uniform((cin, cout, k), cout * k, generator)
        self.bias = _uniform((cout,), cout * k, generator)


class CausalConv1d(nn.Module):
    """Left reflect-padded conv (module/common.py:85-92)."""

    def __init__(self, cin: int, cout: int, k: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(cin, cout, k, generator=generator)

    def forward(self, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        return causal_conv1d(self.conv, x, dilation)


class ChannelNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1, channels, 1))
        self.shift = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_norm(self, x)


class AdaptiveChannelNorm(nn.Module):
    def __init__(self, channels: int, condition_emb: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = Linear(condition_emb, channels, generator)
        self.shift = Linear(condition_emb, channels, generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return adaptive_channel_norm(self, x, cond)


class ConvNeXt1d(nn.Module):
    def __init__(self, channels: int = 512, hidden: int = 1536, kernel_size: int = 7,
                 scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw_conv = Conv(channels, channels, kernel_size, groups=channels, generator=generator)
        self.norm = ChannelNorm(channels)
        self.pw_conv1 = Linear(channels, hidden, generator)
        self.pw_conv2 = Linear(hidden, channels, generator)
        self.scale = nn.Parameter(torch.full((1, channels, 1), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return convnext1d(self, x)


class AdaptiveConvNeXt1d(nn.Module):
    def __init__(self, channels: int = 512, hidden: int = 1536, condition_emb: int = 512,
                 kernel_size: int = 7, scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw_conv = Conv(channels, channels, kernel_size, groups=channels, generator=generator)
        self.norm = AdaptiveChannelNorm(channels, condition_emb, generator)
        self.pw_conv1 = Linear(channels, hidden, generator)
        self.pw_conv2 = Linear(hidden, channels, generator)
        self.scale = nn.Parameter(torch.full((1, channels, 1), scale))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return adaptive_convnext1d(self, x, cond)
