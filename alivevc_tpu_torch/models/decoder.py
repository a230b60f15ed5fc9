"""DDSP decoder: FeatureExtractor -> harmonic source -> filter U-Net
(module/decoder.py:13-210), channels-last.

Every up level of the U-Net runs through ``kernels/filter.py``, where the
JAX package runs ``fused_filter_block_up`` (filter_packed.py:418-440).  The
offline call (phi = 0, crop = (0, -1)) runs the harmonic source through
``kernels/oscillator.py``, where the JAX package runs
``harmonic_source_cheb_pallas`` (decoder.py:402-412); any other phi or crop
(the streaming semantics) takes the plain oscillator, which also returns the
per-harmonic phase.

Rate convs: the down conv (kernel = stride = r) is a reshape + product, the
up conv (transposed, kernel = stride = r) a product + reshape, with the
reference's weights ([Cout, Cin, r] and [Cin, Cout, r]) rearranged to the
JAX package's layouts (decoder.py:16-20, 280-293).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.kernels.filter import filter_level
from alivevc_tpu_torch.kernels.oscillator import harmonic_source
from alivevc_tpu_torch.nn.layers import (
    AdaptiveConvNeXt1d,
    CausalConv1d,
    Conv,
    ConvTranspose,
    Linear,
    causal_conv1d,
    conv1d,
    gelu,
    linear,
)
from alivevc_tpu_torch.ops.interp import linear_interpolate
from alivevc_tpu_torch.utils.profiling import span

# ---------------------------------------------------------------------------
# FeatureExtractor (module/decoder.py:13-48)
# ---------------------------------------------------------------------------


class F0Encoder(nn.Module):
    def __init__(self, output_dim: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = Linear(1, output_dim, generator)
        # c1 is re-initialised to N(0, 0.3) weight, U(-1, 1) bias (decoder.py:18)
        with torch.no_grad():
            self.c1.weight.normal_(0.0, 0.3, generator=generator)
            self.c1.bias.uniform_(-1.0, 1.0, generator=generator)
        self.c2 = Linear(output_dim, output_dim, generator)


def f0_encoder(m: F0Encoder, f0: torch.Tensor) -> torch.Tensor:
    """f0 [N, T, 1] -> sinusoidal condition [N, T, C], in float32 whatever
    the parameter dtype (bf16 would quantise Hz to ~16 steps)."""
    f0 = f0.float()
    x = torch.sin(linear(f0, m.c1.weight.float(), m.c1.bias.float()))
    return linear(x, m.c2.weight.float(), m.c2.bias.float())


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: DecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_layer = Linear(cfg.content_channels, cfg.channels, generator)
        self.f0_enc = F0Encoder(cfg.channels, generator)
        self.mid_layers = nn.ModuleList([
            AdaptiveConvNeXt1d(cfg.channels, cfg.hidden_channels, cfg.channels,
                               cfg.kernel_size, scale=1.0 / cfg.num_layers, generator=generator)
            for _ in range(cfg.num_layers)
        ])


def feature_extractor(m: FeatureExtractor, content: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """content [N, T, 768], f0 [N, T, 1] -> features [N, T, C]."""
    x = m.input_layer(content)
    cond = f0_encoder(m.f0_enc, f0).to(x.dtype)
    for block in m.mid_layers:
        x = block(x, cond)
    return x


# ---------------------------------------------------------------------------
# HarmonicOscillator (module/decoder.py:51-102)
# ---------------------------------------------------------------------------


class HarmonicOscillator(nn.Module):
    def __init__(self, cfg: DecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.to_amps = Linear(cfg.channels, cfg.num_harmonics, generator)


def harmonic_oscillator(m: HarmonicOscillator, features: torch.Tensor, f0: torch.Tensor,
                        phi=0.0, crop: Tuple[int, int] = (0, -1), segment_size: int = 320,
                        sample_rate: int = 16_000, num_harmonics: int = 64):
    """Plain DDSP source with streaming phi/crop semantics:
    features [N, Lf, C], f0 [N, Lf, 1] -> (wave [N, Lw, 1], phi [N, Lw, Nh])."""
    lw = features.shape[1] * segment_size
    amps = torch.exp(m.to_amps(features))
    mul = torch.arange(1, num_harmonics + 1, dtype=torch.float32, device=f0.device)
    formants = linear_interpolate(f0.float() * mul, lw, axis=1)
    amps = linear_interpolate(amps.float(), lw, axis=1)
    dt = torch.cumsum(formants / sample_rate, dim=1)      # float32 phase
    dt = dt - dt[:, crop[0]][:, None, :]
    harmonics = torch.sin(2.0 * math.pi * dt + phi)
    phi_out = torch.asin(harmonics)
    wave = torch.mean(harmonics * amps, dim=2, keepdim=True)
    return wave, phi_out


# ---------------------------------------------------------------------------
# Filter U-Net (module/decoder.py:105-195)
# ---------------------------------------------------------------------------


class ModulatedCausalConv1d(nn.Module):
    def __init__(self, cin: int, cout: int, cond: int, k: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = CausalConv1d(cin, cout, k, generator)
        self.to_scale = Linear(cond, cin, generator)
        self.to_shift = Linear(cond, cin, generator)

    def film(self, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frame-rate (scale + 1, shift) from the condition c [N, Lf, Cc]."""
        return self.to_scale(c) + 1.0, self.to_shift(c)


def modulated_causal_conv1d(m: ModulatedCausalConv1d, x: torch.Tensor, c: torch.Tensor,
                            dilation: int = 1) -> torch.Tensor:
    """FiLM (scale+1 / shift interpolated to signal length), then causal conv."""
    scale, shift = m.film(c)
    x = x * linear_interpolate(scale, x.shape[1], axis=1) + linear_interpolate(shift, x.shape[1], axis=1)
    return causal_conv1d(m.conv.conv, x, dilation)


class FilterResBlock(nn.Module):
    def __init__(self, channels: int, cond: int, k: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = ModulatedCausalConv1d(channels, channels, cond, k, generator)
        self.c2 = ModulatedCausalConv1d(channels, channels, cond, k, generator)


def filter_res_block(m: FilterResBlock, x: torch.Tensor, c: torch.Tensor, dilation: int) -> torch.Tensor:
    res = x
    x = modulated_causal_conv1d(m.c1, gelu(x), c, dilation)
    x = modulated_causal_conv1d(m.c2, gelu(x), c, dilation)
    return x + res


class FilterBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cond: int, k: int = 5, dilations: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_conv = Linear(cin, cout, generator)
        self.blocks = nn.ModuleList([FilterResBlock(cout, cond, k, generator)
                                     for _ in range(dilations)])


def filter_block(m: FilterBlock, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x = m.input_conv(x)
    for d, blk in enumerate(m.blocks):
        x = filter_res_block(blk, x, c, dilation=2 ** d)
    return x


def down_weight(conv: Conv) -> torch.Tensor:
    """[Cout, Cin, r] -> [r*Cin, Cout] (row j*Cin + ci <-> weight[co, ci, j])."""
    cout, cin, r = conv.weight.shape
    return conv.weight.permute(2, 1, 0).reshape(r * cin, cout)


def up_weight(conv: ConvTranspose) -> torch.Tensor:
    """[Cin, Cout, r] -> [Cin, r*Cout] (column j*Cout + co <-> weight[ci, co, j])."""
    cin, cout, r = conv.weight.shape
    return conv.weight.permute(0, 2, 1).reshape(cin, r * cout)


def _down(conv: Conv, x: torch.Tensor, rate: int) -> torch.Tensor:
    """Conv1d(cin, cout, r, stride=r, pad=0) as reshape + product."""
    n, length, cin = x.shape
    return x.reshape(n, length // rate, rate * cin) @ down_weight(conv) + conv.bias


def _up(conv: ConvTranspose, x: torch.Tensor, rate: int) -> torch.Tensor:
    """ConvTranspose1d(cin, cout, r, stride=r, pad=0) as product + reshape."""
    n, length, _ = x.shape
    y = x @ up_weight(conv)
    return y.reshape(n, length * rate, y.shape[-1] // rate) + conv.bias


def level_args(blk: FilterBlock, up: ConvTranspose, cond: torch.Tensor):
    """The weights of one up level in ``kernels/filter.py``'s layouts, and the
    frame-rate FiLM of its six causal convs as one product: [N, F, 12 C],
    conv i's scale (linear + 1, the 1 folded into the bias) in columns
    [2 i C, (2 i + 1) C) and its shift in the next C."""
    conv_w: List[torch.Tensor] = []
    conv_b: List[torch.Tensor] = []
    film_w: List[torch.Tensor] = []
    film_b: List[torch.Tensor] = []
    dilations = []
    for d, rb in enumerate(blk.blocks):
        for mc in (rb.c1, rb.c2):
            conv_w.append(mc.conv.conv.weight.permute(2, 1, 0))
            conv_b.append(mc.conv.conv.bias)
            film_w += [mc.to_scale.weight, mc.to_shift.weight]
            film_b += [mc.to_scale.bias + 1.0, mc.to_shift.bias]
            dilations.append(2 ** d)
    film = linear(cond, torch.cat(film_w), torch.cat(film_b))
    return dict(up_w=up_weight(up), up_b=up.bias, in_w=blk.input_conv.weight[:, :, 0].t(),
                in_b=blk.input_conv.bias, conv_w=conv_w, conv_b=conv_b, film=film,
                dilations=dilations)


class Filter(nn.Module):
    def __init__(self, cfg: DecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        rates = list(cfg.filter_rates)
        chans = list(cfg.filter_channels)
        k = cfg.filter_kernel_size
        chan_nexts = chans[1:] + [chans[-1]]
        self.source_in = Conv(1, chans[0], 7, generator=generator)
        self.downs = nn.ModuleList([Conv(c, cn, r, generator=generator)
                                    for c, cn, r in zip(chans, chan_nexts, rates)])
        self.mid_conv = CausalConv1d(chans[-1], chans[-1], k, generator)
        rchans = list(reversed(chans))
        chan_prevs = [rchans[0]] + rchans[:-1]
        self.ups = nn.ModuleList([ConvTranspose(cp, c, r, generator)
                                  for c, cp, r in zip(rchans, chan_prevs, reversed(rates))])
        self.blocks = nn.ModuleList([FilterBlock(c, c, cfg.channels, k, cfg.filter_dilations, generator)
                                     for c in rchans])
        self.source_out = Conv(chans[0], 1, 7, generator=generator)


def filter_unet(m: Filter, source: torch.Tensor, c: torch.Tensor, cfg: DecoderConfig,
                level=filter_level) -> torch.Tensor:
    """source [N, Lw, 1], c [N, Lf, C] -> filtered wave [N, Lw, 1]; each up
    level runs through ``level``: ``kernels/filter.py:filter_level``
    (``filter_block`` o ``_up``; the kernel on the card), or another
    function of its arguments (``cli/export.py`` passes the plain one)."""
    rates = list(cfg.filter_rates)
    x = conv1d(source, m.source_in.weight, m.source_in.bias, padding=3)
    skips = []
    for dp, r in zip(m.downs, rates):
        x = _down(dp, x, r)
        skips.append(x)
    x = m.mid_conv(x)
    for up, blk, s, r in zip(m.ups, m.blocks, reversed(skips), reversed(rates)):
        x = level(x, s, rate=r, **level_args(blk, up, c))
    return conv1d(x, m.source_out.weight, m.source_out.bias, padding=3)


# ---------------------------------------------------------------------------
# Decoder top (module/decoder.py:198-210)
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig = DecoderConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg, generator)
        self.harmonic_oscillator = HarmonicOscillator(cfg, generator)
        self.filter = Filter(cfg, generator)


def decoder(m: Decoder, content: torch.Tensor, f0: torch.Tensor, phi=0.0,
            crop: Tuple[int, int] = (0, -1), cfg: Optional[DecoderConfig] = None):
    """content [N, Lf, 768], f0 [N, Lf, 1] -> (wave [N, Lw], phi [N, Lw, Nh]
    or None).  The offline call (phi the number 0, crop = (0, -1)) runs the
    Chebyshev source kernel and returns phi as None."""
    cfg = m.cfg if cfg is None else cfg
    with span("decoder.source"):
        feats = feature_extractor(m.feature_extractor, content, f0)
        offline = crop == (0, -1) and not torch.is_tensor(phi) and phi == 0
        if offline:
            amps = torch.exp(m.harmonic_oscillator.to_amps(feats))
            source = harmonic_source(f0, amps, cfg.sample_rate, cfg.segment_size)
            phi_out = None
        else:
            source, phi_out = harmonic_oscillator(
                m.harmonic_oscillator, feats, f0, phi=phi, crop=crop, segment_size=cfg.segment_size,
                sample_rate=cfg.sample_rate, num_harmonics=cfg.num_harmonics)
    out = filter_unet(m.filter, source.to(feats.dtype), feats, cfg)
    return out[..., 0], phi_out
