"""GAN discriminators: MultiPeriod (MPD) + MultiResolution (MRD)
(module/discriminator.py:14-193), used only by decoder training and
fine-tuning.

The modules hold the reference's state-dict names and layouts, the ones
``alivevc_tpu/compat/torch_import.py:204-244`` reads:
``MPD.sub_discriminators.{i}.{input_layer, layers.{j}, final_conv,
output_layer}`` and ``MRD.sub_discriminators.{i}.{layers.{j}, conv_post}``,
each with ``weight_g`` [out, 1, 1, 1], ``weight_v`` [out, in / groups, kh,
kw] and ``bias`` [out].  A weight-normalised conv computes w = g v / ||v||,
the norm over every axis but the output channel (torch ``weight_norm``,
dim 0).  Images run NCHW inside: a period sub-discriminator sees the wave
as [N, 1, L/p, p] and convolves along L/p; a resolution sub-discriminator
sees the magnitude STFT as [N, 1, bins, frames] (rectangular window, as the
reference passes no window to torch.stft).  ``discriminator_logits``
returns channels-last [N, H, W, 1] tensors, the JAX package's layout.

The two quirks of the reference (SURVEY §2.4.2) are kept:
  * the MPD features are the five stage-conv outputs before activation;
  * the MRD features are the final activation alone, split over the batch,
    so the feature loss sees N per-item tensors per resolution: that term
    is a sum over the batch, not a mean.
The MRD's STFT at n_fft 512 / 1024 / 2048 is the plain
``ops/stft.stft_magnitude``, as the JAX package uses its XLA one there: the
STFT kernel computes only n_fft 1280.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.config import DiscriminatorConfig
from alivevc_tpu_torch.ops.stft import stft_magnitude

# (kh, kw, sh, sw, ph, pw) of the resolution sub-discriminator's five convs
RES_LAYERS = (
    (7, 5, 2, 2, 3, 2),
    (5, 3, 2, 1, 2, 1),
    (5, 3, 2, 2, 2, 1),
    (3, 3, 2, 1, 1, 1),
    (3, 3, 2, 2, 1, 1),
)


class WNConv2d(nn.Module):
    """Weight-normalised Conv2d parameters.  Init as the JAX package's:
    v and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), g = ||v||."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = (cin // groups) * kh * kw
        bound = 1.0 / math.sqrt(fan_in)
        v = torch.empty(cout, cin // groups, kh, kw).uniform_(-bound, bound, generator=generator)
        self.weight_g = nn.Parameter(v.flatten(1).norm(dim=1).reshape(cout, 1, 1, 1))
        self.weight_v = nn.Parameter(v)
        self.bias = nn.Parameter(torch.empty(cout).uniform_(-bound, bound, generator=generator))
        self.groups = groups

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return self.weight_g * v / torch.sqrt((v * v).sum(dim=(1, 2, 3), keepdim=True))


def wn_conv2d(m: WNConv2d, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    return F.conv2d(x, m.weight(), m.bias, stride=stride, padding=padding, groups=m.groups)


def _get_padding(k: int) -> int:
    return (k - 1) // 2


class PeriodicDiscriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        ch, ks, ns, mc = (cfg.period_channels, cfg.period_kernel_size, cfg.period_stages,
                          cfg.period_max_channels)
        self.input_layer = WNConv2d(1, ch, ks, 1, generator=generator)
        layers = []
        for i in range(ns):
            c = min(ch * 4 ** i, mc)
            c_next = c if i == ns - 1 else min(ch * 4 ** (i + 1), mc)
            layers.append(WNConv2d(c, c_next, ks, 1, groups=cfg.period_groups[i],
                                   generator=generator))
        self.layers = nn.ModuleList(layers)
        c = min(ch * 4 ** (ns - 1), mc)
        self.final_conv = WNConv2d(c, c, 5, 1, generator=generator)
        self.output_layer = WNConv2d(c, 1, 3, 1, generator=generator)


def periodic_discriminator(m: PeriodicDiscriminator, x: torch.Tensor, period: int,
                           cfg: DiscriminatorConfig, want_feat: bool):
    """wave [N, L] -> logits [N, 1, H, W], or (``want_feat``) the stage
    convs' outputs before activation."""
    n, length = x.shape
    if length % period:
        x = F.pad(x, (0, period - length % period))
    img = x.reshape(n, period, -1).transpose(1, 2)[:, None]      # [N, 1, L/p, p]
    st = cfg.period_stride
    pad = _get_padding(cfg.period_kernel_size)
    # an int padding pads both axes, the period axis too (the reference's)
    h = wn_conv2d(m.input_layer, img, stride=(st, 1), padding=(pad, pad))
    feats: List[torch.Tensor] = []
    for i, layer in enumerate(m.layers):
        h = wn_conv2d(layer, h, stride=(st, 1), padding=(pad, pad))
        feats.append(h)
        if i != len(m.layers) - 1:
            h = F.leaky_relu(h, cfg.lrelu_slope)
    if want_feat:
        return feats
    h = F.leaky_relu(wn_conv2d(m.final_conv, h, padding=(2, 2)), cfg.lrelu_slope)
    return wn_conv2d(m.output_layer, h, padding=(1, 1))


class ResolutionDiscriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        ch = cfg.resolution_channels
        self.layers = nn.ModuleList([WNConv2d(1 if i == 0 else ch, ch, kh, kw, generator=generator)
                                     for i, (kh, kw, *_) in enumerate(RES_LAYERS)])
        self.conv_post = WNConv2d(ch, 1, 3, 3, generator=generator)


def resolution_discriminator(m: ResolutionDiscriminator, x: torch.Tensor, n_fft: int,
                             cfg: DiscriminatorConfig, want_feat: bool) -> torch.Tensor:
    """wave [N, L] -> logits [N, 1, H, W], or (``want_feat``) the final
    activation [N, C, H, W]."""
    mag = stft_magnitude(x, n_fft, n_fft // 4, None, "rect", True)   # [N, frames, bins]
    h = mag.transpose(1, 2)[:, None]                                  # [N, 1, bins, frames]
    for layer, (_, _, sh, sw, ph, pw) in zip(m.layers, RES_LAYERS):
        h = F.leaky_relu(wn_conv2d(layer, h, stride=(sh, sw), padding=(ph, pw)), cfg.lrelu_slope)
    if want_feat:
        return h
    return wn_conv2d(m.conv_post, h, padding=(1, 1))


class SubDiscriminators(nn.Module):
    def __init__(self, subs):
        super().__init__()
        self.sub_discriminators = nn.ModuleList(subs)


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.MPD = SubDiscriminators([PeriodicDiscriminator(cfg, generator) for _ in cfg.periods])
        self.MRD = SubDiscriminators([ResolutionDiscriminator(cfg, generator)
                                      for _ in cfg.resolutions])


def discriminator_logits(m: Discriminator, x: torch.Tensor) -> List[torch.Tensor]:
    """wave [N, L] -> one logit tensor [N, H, W, 1] per sub-discriminator
    (the periods', then the resolutions')."""
    cfg = m.cfg
    logits = [periodic_discriminator(d, x, p, cfg, False)
              for d, p in zip(m.MPD.sub_discriminators, cfg.periods)]
    logits += [resolution_discriminator(d, x, n, cfg, False)
               for d, n in zip(m.MRD.sub_discriminators, cfg.resolutions)]
    return [lg.permute(0, 2, 3, 1) for lg in logits]


def discriminator_feats(m: Discriminator, x: torch.Tensor) -> List[torch.Tensor]:
    """The feature list of the feature-matching loss, with both quirks."""
    cfg = m.cfg
    feats: List[torch.Tensor] = []
    for d, p in zip(m.MPD.sub_discriminators, cfg.periods):
        feats += periodic_discriminator(d, x, p, cfg, True)
    for d, n in zip(m.MRD.sub_discriminators, cfg.resolutions):
        feats += list(resolution_discriminator(d, x, n, cfg, True).unbind(0))
    return feats


def discriminator_feat_loss(m: Discriminator, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Sum over matched feature pairs of mean |fake - real|; the real branch
    carries no gradient (module/discriminator.py:184-190)."""
    with torch.no_grad():
        real_feats = discriminator_feats(m, real)
    loss = fake.new_zeros(())
    for r, f in zip(real_feats, discriminator_feats(m, fake)):
        loss = loss + (f - r).abs().mean()
    return loss
