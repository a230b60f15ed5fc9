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

``NsfHiFiGAN`` is RVC's ``GeneratorNSF`` (infer/lib/infer_pack/models.py) on
the same stage loop and ResBlock path: no ``lin_pre``, ``cond(g)`` added
after ``conv_pre``, the harmonic source (``SourceModuleHnNSF``: RVC's
``SineGen`` of the frame-rate F0, through ``m_source.l_linear`` and tanh)
added to each stage through its strided ``noise_convs`` conv after the
transposed conv, and ``conv_post`` without a bias.
"""

from __future__ import annotations


import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.config import HiFiGANConfig, NsfGeneratorConfig
from alivevc_tpu_torch.kernels.hifigan import hifigan_conv
from alivevc_tpu_torch.utils.profiling import span


def _padding(k: int, dilation: int = 1) -> int:
    return (k * dilation - dilation) // 2


class _ResBlock1(nn.Module):
    def __init__(self, c: int, k: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(c, c, k, padding=_padding(k, d), dilation=d)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(c, c, k, padding=_padding(k)) for _ in dilations])


def _stages(m: nn.Module, cfg) -> int:
    """The upsampling stages' transposed convs and ResBlock1 stacks (the
    published names ``ups`` and ``resblocks``) on ``m``; returns the last
    stage's channels."""
    c = cfg.upsample_initial_channel
    m.ups = nn.ModuleList()
    m.resblocks = nn.ModuleList()
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        cin, c = c, c // 2
        m.ups.append(nn.ConvTranspose1d(cin, c, k, u, padding=(k - u) // 2))
        for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            m.resblocks.append(_ResBlock1(c, kr, dils))
    return c


class HiFiGAN(nn.Module):
    """The generator's parameters, at ``cfg``'s widths."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.lin_pre = nn.Linear(cfg.input_channels, cfg.hidden_channels)
        self.conv_pre = nn.Conv1d(cfg.hidden_channels, cfg.upsample_initial_channel, 7, padding=3)
        c = _stages(self, cfg)
        self.conv_post = nn.Conv1d(c, 1, 7, padding=3)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return hifigan(self, feats)


class _SourceModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.l_linear = nn.Linear(1, 1)     # harmonic_num 0: one sine


class NsfHiFiGAN(nn.Module):
    """RVC's ``GeneratorNSF`` parameters (names as its state dict holds them
    under ``dec.``, weight norm folded), at ``cfg``'s widths."""

    def __init__(self, cfg: NsfGeneratorConfig = NsfGeneratorConfig()):
        super().__init__()
        self.cfg = cfg
        self.m_source = _SourceModule()
        self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(cfg.initial_channel, cfg.upsample_initial_channel, 7, padding=3)
        c = _stages(self, cfg)
        for i, up in enumerate(self.ups):
            s = math.prod(cfg.upsample_rates[i + 1:])
            self.noise_convs.append(nn.Conv1d(1, up.out_channels, 2 * s, s, padding=s // 2) if s > 1
                                    else nn.Conv1d(1, up.out_channels, 1))
        self.conv_post = nn.Conv1d(c, 1, 7, padding=3, bias=False)
        self.cond = nn.Conv1d(cfg.gin_channels, cfg.upsample_initial_channel, 1)


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


def _upsample(m: nn.Module, x: torch.Tensor, source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stage loop on x [N, C, T] channels first: each stage's leaky ReLU
    and transposed conv, the source [N, 1, L] through the stage's noise conv
    where given, then the mean of its ResBlock1 stacks; then the final
    leaky ReLU (slope 0.01) and ``conv_post``, and tanh: [N, T * hop]."""
    cfg = m.cfg
    slope = cfg.lrelu_slope
    kernels = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(m.ups):
        x = F.conv_transpose1d(F.leaky_relu(x, slope), up.weight, up.bias, stride=up.stride,
                               padding=up.padding)
        if source is not None:
            nc = m.noise_convs[i]
            x = x + F.conv1d(source, nc.weight, nc.bias, stride=nc.stride, padding=nc.padding)
        x = _resblocks(m.resblocks[i * kernels:(i + 1) * kernels], x.transpose(1, 2).contiguous(), slope)
        x = x.transpose(1, 2).contiguous()                                # [N, C, T]
    x = _conv(m.conv_post, F.leaky_relu(x))                               # slope 0.01
    return torch.tanh(x)[:, 0]


def hifigan(m: HiFiGAN, feats: torch.Tensor) -> torch.Tensor:
    """feats [N, T, input_channels] -> waveform [N, T * hop_length] in
    [-1, 1]."""
    x = m.lin_pre(feats).transpose(1, 2)                                  # [N, C, T]
    return _upsample(m, _conv(m.conv_pre, x))


def sine_source(f0: torch.Tensor, upp: int, sample_rate: int, noise: torch.Tensor, sine_amp: float = 0.1,
                noise_std: float = 0.003) -> torch.Tensor:
    """RVC's ``SineGen`` (harmonic_num 0) of the frame-rate F0 [N, T] (Hz, 0
    unvoiced) -> [N, T * upp, 1]: the phase increments (f0 / sr) % 1 summed
    at the frame rate, times upp, linearly upsampled (align_corners) and
    wrapped; each wrap is a -1 shift of the sample-rate cumulative sum of
    the nearest-upsampled increments; sin(2 pi .) * sine_amp where voiced,
    plus ``noise`` [N, T * upp, 1] (standard normal, drawn by the caller)
    times noise_std where voiced and sine_amp / 3 where not."""
    f0 = f0[:, :, None]                                                   # [N, T, 1]
    rad = (f0 / sample_rate) % 1
    over = torch.cumsum(rad, 1) * upp
    over = F.interpolate(over.transpose(2, 1), scale_factor=float(upp), mode="linear",
                         align_corners=True).transpose(2, 1)
    rad = F.interpolate(rad.transpose(2, 1), scale_factor=float(upp), mode="nearest").transpose(2, 1)
    over = over % 1
    shift = torch.zeros_like(rad)
    shift[:, 1:, :] = ((over[:, 1:, :] - over[:, :-1, :]) < 0) * -1.0
    sine = torch.sin(torch.cumsum(rad + shift, dim=1) * 2 * math.pi) * sine_amp
    uv = F.interpolate((f0 > 0).float().transpose(2, 1), scale_factor=float(upp),
                       mode="nearest").transpose(2, 1)
    return sine * uv + (uv * noise_std + (1 - uv) * sine_amp / 3) * noise


def nsf_hifigan(m: NsfHiFiGAN, z: torch.Tensor, f0: torch.Tensor, g: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """z [N, initial_channel, T] (channels first, as the flow leaves it), f0
    [N, T] Hz, g [N, gin_channels, 1], ``noise`` [N, T * hop, 1] standard
    normal -> waveform [N, T * hop] in [-1, 1]."""
    cfg = m.cfg
    with span("rvc.source"):
        sine = sine_source(f0, cfg.hop_length, cfg.sample_rate, noise, cfg.sine_amp, cfg.noise_std)
        source = torch.tanh(m.m_source.l_linear(sine)).transpose(1, 2)   # [N, 1, T * hop]
    x = _conv(m.conv_pre, z) + _conv(m.cond, g)
    return _upsample(m, x, source)
