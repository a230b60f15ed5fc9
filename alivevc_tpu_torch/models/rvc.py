"""RVC v2's synthesizer at inference (``SynthesizerTrnMs768NSFsid.infer``,
github.com/RVC-Project/Retrieval-based-Voice-Conversion-WebUI,
infer/lib/infer_pack/models.py, attentions.py, modules.py): content and
pitch -> the prior -> a draw -> the reversed flow -> the NSF generator.

    x    = LeakyReLU_0.1(sqrt(192) (emb_phone(feats) + emb_pitch(coarse)))
    x    = 6 post-LN layers: LN(x + relative attention(x)), LN(x + FFN(x))
    m, logs_p = proj(x);  z_p = m + exp(logs_p) * eps * 0.66666
    z    = the flow reversed: 4 x [flip channels, x1 -= post(WN(pre(x0), g))]
    wave = GeneratorNSF(z, f0, g)   (``models/hifigan.py:nsf_hifigan``)

The attention is VITS's (attentions.py:MultiHeadAttention, window 10, heads
sharing ``emb_rel_k`` / ``emb_rel_v`` [1, 21, d_head]): logits
q.k / sqrt(d) plus q.e_k[j - i] / sqrt(d) for |j - i| <= 10, and the output
p @ v plus sum_j p_ij e_v[j - i] over the same band.  VITS builds the band
through [T, 2T - 1] tensors; here the scores are laid out [T, T + 20] (ten
columns of -inf on each side), so that the band of query i is a strided view
of 21 entries starting at column i: the relative logits are added to it in
place and the relative weights read from it, with no other T^2 tensor.

Parameters have the published names (``enc_p.*``, ``flow.flows.{0,2,4,6}.*``,
``dec.*``, ``emb_g``), weight norm folded into plain weights; activations are
channels first [N, C, T], as RVC's.  Plain PyTorch; the caller chooses the
math (``device.float32_math`` in the fp32 mode).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.config import RvcConfig
from alivevc_tpu_torch.models.hifigan import NsfHiFiGAN


class _Norm(nn.Module):
    """attentions.py's LayerNorm over channels (``gamma``, ``beta``)."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))


class _RelAttention(nn.Module):
    def __init__(self, c: int, heads: int, window: int):
        super().__init__()
        self.conv_q = nn.Conv1d(c, c, 1)
        self.conv_k = nn.Conv1d(c, c, 1)
        self.conv_v = nn.Conv1d(c, c, 1)
        self.conv_o = nn.Conv1d(c, c, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window + 1, c // heads))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window + 1, c // heads))


class _FFN(nn.Module):
    def __init__(self, c: int, filt: int, k: int):
        super().__init__()
        self.conv_1 = nn.Conv1d(c, filt, k)
        self.conv_2 = nn.Conv1d(filt, c, k)


class _Encoder(nn.Module):
    def __init__(self, cfg: RvcConfig):
        super().__init__()
        c, n = cfg.hidden_channels, cfg.n_layers
        self.attn_layers = nn.ModuleList([_RelAttention(c, cfg.n_heads, cfg.window_size) for _ in range(n)])
        self.norm_layers_1 = nn.ModuleList([_Norm(c) for _ in range(n)])
        self.ffn_layers = nn.ModuleList([_FFN(c, cfg.filter_channels, cfg.kernel_size) for _ in range(n)])
        self.norm_layers_2 = nn.ModuleList([_Norm(c) for _ in range(n)])


class TextEncoder(nn.Module):
    """``enc_p`` (TextEncoder768)."""

    def __init__(self, cfg: RvcConfig):
        super().__init__()
        self.emb_phone = nn.Linear(cfg.phone_channels, cfg.hidden_channels)
        self.emb_pitch = nn.Embedding(cfg.pitch_bins, cfg.hidden_channels)
        self.encoder = _Encoder(cfg)
        self.proj = nn.Conv1d(cfg.hidden_channels, 2 * cfg.inter_channels, 1)


class _WN(nn.Module):
    def __init__(self, cfg: RvcConfig):
        super().__init__()
        h, k, n = cfg.hidden_channels, cfg.flow_kernel_size, cfg.flow_layers
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        self.cond_layer = nn.Conv1d(cfg.gin_channels, 2 * h * n, 1)
        for i in range(n):
            d = cfg.flow_dilation_rate ** i
            self.in_layers.append(nn.Conv1d(h, 2 * h, k, dilation=d, padding=(k * d - d) // 2))
            self.res_skip_layers.append(nn.Conv1d(h, 2 * h if i < n - 1 else h, 1))


class _Coupling(nn.Module):
    """A mean-only ResidualCouplingLayer."""

    def __init__(self, cfg: RvcConfig):
        super().__init__()
        half = cfg.inter_channels // 2
        self.pre = nn.Conv1d(half, cfg.hidden_channels, 1)
        self.enc = _WN(cfg)
        self.post = nn.Conv1d(cfg.hidden_channels, half, 1)


class _Flip(nn.Module):
    pass


class Flow(nn.Module):
    """``flow`` (ResidualCouplingBlock): coupling layers at the even places,
    flips (no parameters) at the odd ones."""

    def __init__(self, cfg: RvcConfig):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(cfg.n_flows):
            self.flows.append(_Coupling(cfg))
            self.flows.append(_Flip())


class RvcSynthesizer(nn.Module):
    """The inference parameters of ``SynthesizerTrnMs768NSFsid`` (its state
    dict without the posterior encoder ``enc_q``, which inference drops)."""

    def __init__(self, cfg: RvcConfig = RvcConfig()):
        super().__init__()
        self.cfg = cfg
        self.enc_p = TextEncoder(cfg)
        self.dec = NsfHiFiGAN(cfg.generator)
        self.flow = Flow(cfg)
        self.emb_g = nn.Embedding(cfg.spk_embed_dim, cfg.gin_channels)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return F.conv1d(x, conv.weight, conv.bias, padding=conv.padding, dilation=conv.dilation)


def _norm(m: _Norm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.transpose(1, 2), (x.shape[1],), m.gamma, m.beta, 1e-5).transpose(1, 2)


def _band(s: torch.Tensor, width: int) -> torch.Tensor:
    """The [B, T, width] view of s [B, T, T + width - 1] (contiguous) whose
    row i holds columns i .. i + width - 1."""
    b, t, w = s.shape
    return s.as_strided((b, t, width), (t * w, w + 1, 1), s.storage_offset())


def rel_attention(m: _RelAttention, x: torch.Tensor, heads: int, window: int) -> torch.Tensor:
    """VITS's windowed relative-position self-attention of x [N, C, T] (no
    mask: one whole sequence) -> [N, C, T]."""
    n, c, t = x.shape
    hd = c // heads
    split = lambda y: y.reshape(n * heads, hd, t).transpose(1, 2)     # noqa: E731  [NH, T, hd]
    q = split(_conv(m.conv_q, x)) / math.sqrt(hd)
    k, v = split(_conv(m.conv_k, x)), split(_conv(m.conv_v, x))
    width = 2 * window + 1
    # scores [NH, T, T + 2 window]: column j + window holds key j, the rest -inf
    s = F.pad(q @ k.transpose(1, 2), (window, window), value=float("-inf"))
    band = _band(s, width)                                            # [NH, T, 21]: keys i - w .. i + w
    band += q @ m.emb_rel_k[0].t()
    p = torch.softmax(s, dim=-1)
    out = p[:, :, window:window + t] @ v + _band(p, width) @ m.emb_rel_v[0]
    return _conv(m.conv_o, out.transpose(1, 2).reshape(n, c, t))


def prior(m: TextEncoder, cfg: RvcConfig, phone: torch.Tensor, pitch: torch.Tensor) -> Tuple[torch.Tensor,
                                                                                           torch.Tensor]:
    """phone [N, T, 768] features, pitch [N, T] coarse bins -> (m_p,
    logs_p), each [N, inter_channels, T]."""
    x = (m.emb_phone(phone) + m.emb_pitch(pitch)) * math.sqrt(cfg.hidden_channels)
    x = F.leaky_relu(x, 0.1).transpose(1, 2)                          # [N, C, T]
    stats = _conv(m.proj, encoder(m.encoder, cfg, x))
    return stats[:, :cfg.inter_channels], stats[:, cfg.inter_channels:]


def encoder(m: _Encoder, cfg: RvcConfig, x: torch.Tensor) -> torch.Tensor:
    """attentions.py's Encoder on x [N, C, T] (no mask): each layer
    LN(x + attention(x)), then LN(x + FFN(x)), the FFN two 'same' convs with
    a ReLU between."""
    pad = ((cfg.kernel_size - 1) // 2, cfg.kernel_size // 2)
    for i in range(cfg.n_layers):
        x = _norm(m.norm_layers_1[i], x + rel_attention(m.attn_layers[i], x, cfg.n_heads, cfg.window_size))
        ffn = m.ffn_layers[i]
        y = F.conv1d(F.pad(x, pad), ffn.conv_1.weight, ffn.conv_1.bias)
        y = F.conv1d(F.pad(torch.relu(y), pad), ffn.conv_2.weight, ffn.conv_2.bias)
        x = _norm(m.norm_layers_2[i], x + y)
    return x


def _wn(m: _WN, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gated WaveNet of x [N, H, T] conditioned on g [N, gin, 1]."""
    h = x.shape[1]
    n = len(m.in_layers)
    g = _conv(m.cond_layer, g)
    out = torch.zeros_like(x)
    for i in range(n):
        a = _conv(m.in_layers[i], x) + g[:, 2 * h * i:2 * h * (i + 1)]
        acts = torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:])
        rs = _conv(m.res_skip_layers[i], acts)
        if i < n - 1:
            x = x + rs[:, :h]
            out = out + rs[:, h:]
        else:
            out = out + rs
    return out


def flow_reverse(m: Flow, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """z [N, C, T] through the flow in reverse: from the last place to the
    first, each flip reverses the channels and each coupling layer takes
    post(WN(pre(x0), g)) from the second half."""
    for layer in reversed(m.flows):
        if isinstance(layer, _Flip):
            z = torch.flip(z, [1])
            continue
        half = z.shape[1] // 2
        x0, x1 = z[:, :half], z[:, half:]
        mean = _conv(layer.post, _wn(layer.enc, _conv(layer.pre, x0), g))
        z = torch.cat([x0, x1 - mean], dim=1)
    return z

