"""kNN-VC's "prematched" HiFi-GAN V1 generator (github.com/bshall/knn-vc
hifigan/models.py:Generator; Kong et al. 2020), the vocoder of the kNN-VC
family: WavLM features [N, T, 1 024] -> 16 kHz waveform [N, 320 T].

    lin_pre -> conv_pre (k 7) -> 4 x [LeakyReLU 0.1 -> transposed conv
    (x10, x8, x2, x2) -> mean of three ResBlock1 stacks (taps 3, 7, 11;
    dilations 1, 3, 5)] -> LeakyReLU 0.01 -> conv_post (k 7) -> tanh

The state dict has the published module names with weight norm removed
(kNN-VC calls ``remove_weight_norm`` before inference), so each conv holds a
plain ``weight``.  ``lin_pre``, ``conv_pre``, the transposed convs and
``conv_post`` are plain ``F.conv1d`` / ``F.conv_transpose1d`` on the
channels-first layout they take; the caller chooses their math
(``device.float32_math`` in the fp32 mode).  The ResBlocks of a stage run
channels last, [N, T, C], one ``kernels/hifigan.py:hifigan_conv`` a conv
(the leaky ReLU before it, the residual and the stack mean after it
inside the call; 3xTF32 on the card), between one layout change after the
transposed conv and one before the next.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.config import HiFiGANConfig
from alivevc_tpu_torch.kernels.hifigan import hifigan_conv


def _padding(k: int, dilation: int = 1) -> int:
    return (k * dilation - dilation) // 2


class _ResBlock1(nn.Module):
    def __init__(self, c: int, k: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(c, c, k, padding=_padding(k, d), dilation=d)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(c, c, k, padding=_padding(k)) for _ in dilations])


class HiFiGAN(nn.Module):
    """The generator's parameters, at ``cfg``'s widths."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.lin_pre = nn.Linear(cfg.input_channels, cfg.hidden_channels)
        self.conv_pre = nn.Conv1d(cfg.hidden_channels, cfg.upsample_initial_channel, 7, padding=3)
        c = cfg.upsample_initial_channel
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, c = c, c // 2
            self.ups.append(nn.ConvTranspose1d(cin, c, k, u, padding=(k - u) // 2))
            for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(_ResBlock1(c, kr, dils))
        self.conv_post = nn.Conv1d(c, 1, 7, padding=3)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return hifigan(self, feats)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return F.conv1d(x, conv.weight, conv.bias, padding=conv.padding, dilation=conv.dilation)


def _resblocks(blocks, x: torch.Tensor, slope: float) -> torch.Tensor:
    """The mean of a stage's ResBlock1 stacks on x [N, T, C]: each pair
    x + c2(leaky(c1(leaky(x)))), the stacks' sum taken by the last conv of
    each, in the order ((rb0 + rb1) + rb2) / 3 (three stacks)."""
    acc = None
    for s, m in enumerate(blocks):
        h, pairs = x, list(zip(m.convs1, m.convs2))
        for p, (c1, c2) in enumerate(pairs):
            y = hifigan_conv(h, c1, slope)
            last = p == len(pairs) - 1
            h = hifigan_conv(y, c2, slope, res=h, acc=acc if last else None,
                             stack=(s, len(blocks)) if last else None)
        acc = h
    return acc


def hifigan(m: HiFiGAN, feats: torch.Tensor) -> torch.Tensor:
    """feats [N, T, input_channels] -> waveform [N, T * hop_length] in
    [-1, 1]."""
    cfg = m.cfg
    slope = cfg.lrelu_slope
    kernels = len(cfg.resblock_kernel_sizes)
    x = m.lin_pre(feats).transpose(1, 2)                                  # [N, C, T]
    x = _conv(m.conv_pre, x)
    for i, up in enumerate(m.ups):
        x = F.conv_transpose1d(F.leaky_relu(x, slope), up.weight, up.bias, stride=up.stride,
                               padding=up.padding)
        x = _resblocks(m.resblocks[i * kernels:(i + 1) * kernels], x.transpose(1, 2).contiguous(), slope)
        x = x.transpose(1, 2).contiguous()                                # [N, C, T]
    x = _conv(m.conv_post, F.leaky_relu(x))                               # slope 0.01
    return torch.tanh(x)[:, 0]
