"""WavLM, the content encoder's distillation teacher (``microsoft/wavlm-base-plus``,
module/hubert.py:6-22; ``alivevc_tpu/models/wavlm.py``).

A 7-layer conv feature encoder (the first layer followed by a per-channel
norm over time), the feature projection, a weight-normed grouped conv
positional embedding, and post-LN transformer layers with WavLM's gated
relative position bias: T5-style log buckets, one bias table (layer 0's
``rel_attn_embed``) shared by every layer, gated per query and head by a
sigmoid of a projection of the head's slice of the hidden state.

The module's ``state_dict()`` has Hugging Face ``WavLMModel``'s key names,
with the positional conv in ``torch.nn.utils.parametrizations.weight_norm``
form (``parametrizations.weight.original0`` = g [1, 1, k], ``original1`` =
v [C, C / groups, k]); ``import_wavlm`` also reads the older ``weight_g`` /
``weight_v`` form and leaves out ``masked_spec_embed`` (pre-training only).

Activations are channels-last [N, T, C] as in the JAX package.  Attention is
plain ``matmul`` + softmax on [N, H, T, T]: JAX computes it in XLA, with no
Pallas kernel.  ``wavlm_features`` is extract_hubert_feature: the mean of
hidden states 4 and 9, linearly interpolated to ``L // 320`` frames.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.nn.layers import gelu
from alivevc_tpu_torch.ops.interp import linear_interpolate

# keys of a Hugging Face state dict that the forward pass does not read
UNUSED_KEYS = ("masked_spec_embed",)


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5


# ---------------------------------------------------------------------------
# modules (Hugging Face names)
# ---------------------------------------------------------------------------


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, bias=bias)
        if norm:   # GroupNorm(C groups over C channels): a per-channel norm over time
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        cins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList([
            _ConvLayer(ci, co, k, cfg.conv_bias, i == 0)
            for i, (ci, co, k) in enumerate(zip(cins, cfg.conv_dim, cfg.conv_kernel))])


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _PosConv(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, cfg.num_conv_pos_embeddings,
                         padding=cfg.num_conv_pos_embeddings // 2,
                         groups=cfg.num_conv_pos_embedding_groups)
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)


class _Attention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.q_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.gru_rel_pos_linear = nn.Linear(d // h, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        if has_rel_embed:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, h)


class _FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        self.attention = _Attention(cfg, has_rel_embed)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([_EncoderLayer(cfg, i == 0) for i in range(cfg.num_layers)])


class WavLM(nn.Module):
    """``WavLMModel``'s parameters (eval-mode forward, no mask, no dropout)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wave: torch.Tensor) -> List[torch.Tensor]:
        return wavlm_hidden_states(self, wave)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rel_buckets_np(qlen: int, klen: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style log bucketing (WavLMAttention._relative_positions_bucket),
    [qlen, klen] int64.  The log is taken in float64 numpy, as the JAX
    package takes it: in float32 some bucket edges move."""
    nb = num_buckets // 2
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact) / math.log(
        max_distance / max_exact) * (nb - max_exact)
    large = np.minimum((max_exact + large).astype(np.int64), nb - 1)
    return buckets + np.where(is_small, rel, large)


def _feature_encoder(m: _FeatureExtractor, wave: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """wave [N, L] -> [N, T', conv_dim[-1]] (~49.8 frames a second)."""
    x = wave[:, None, :]                                     # [N, 1, L]
    for i, layer in enumerate(m.conv_layers):
        x = F.conv1d(x, layer.conv.weight, layer.conv.bias, stride=cfg.conv_stride[i])
        if i == 0:
            x = F.group_norm(x, x.shape[1], layer.layer_norm.weight, layer.layer_norm.bias, 1e-5)
        x = gelu(x)
    return x.transpose(1, 2)


def _pos_conv(m: _PosConv, x: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """Weight-normed grouped conv (norm over all axes but the taps), the last
    frame dropped for an even tap count (SamePadLayer), then GELU."""
    conv = m.conv
    y = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding,
                 groups=conv.groups).transpose(1, 2)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        y = y[:, :-1]
    return gelu(y)


def _attention(m: _Attention, x: torch.Tensor, position_bias: torch.Tensor,
               cfg: WavLMConfig) -> torch.Tensor:
    """Gated relative-position-bias self-attention.  position_bias [H, T, T]."""
    n, t, d = x.shape
    h = cfg.num_heads
    hd = d // h
    heads = lambda y: y.reshape(n, t, h, hd).transpose(1, 2)   # noqa: E731  [N, H, T, hd]
    # the gate reads the unprojected hidden state, head by head
    proj = m.gru_rel_pos_linear(heads(x)).reshape(n, h, t, 2, 4).sum(-1)   # [N, H, T, 2]
    gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)                  # [N, H, T, 1]
    gate = gate_a * (gate_b * m.gru_rel_pos_const - 1.0) + 2.0
    q, k, v = heads(m.q_proj(x)), heads(m.k_proj(x)), heads(m.v_proj(x))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + gate * position_bias[None]
    out = torch.softmax(scores, dim=-1) @ v
    return m.out_proj(out.transpose(1, 2).reshape(n, t, d))


def _encoder_layer(m: _EncoderLayer, x: torch.Tensor, position_bias: torch.Tensor,
                   cfg: WavLMConfig) -> torch.Tensor:
    """Post-LN layer (do_stable_layer_norm=False for base-plus)."""
    x = m.layer_norm(x + _attention(m.attention, x, position_bias, cfg))
    ff = m.feed_forward.output_dense(gelu(m.feed_forward.intermediate_dense(x)))
    return m.final_layer_norm(x + ff)


def wavlm_hidden_states(m: WavLM, wave: torch.Tensor,
                        upto: Optional[int] = None) -> List[torch.Tensor]:
    """wave [N, L] -> the hidden states [N, T', hidden]: the encoder's input
    and each layer's output (``WavLMModel(..., output_hidden_states=True)
    .hidden_states``, 13 for the default config), or the first ``upto + 1``
    of them."""
    cfg = m.cfg
    x = _feature_encoder(m.feature_extractor, wave, cfg)
    x = m.feature_projection.projection(m.feature_projection.layer_norm(x))
    x = m.encoder.layer_norm(x + _pos_conv(m.encoder.pos_conv_embed, x, cfg))
    t = x.shape[1]
    buckets = torch.from_numpy(rel_buckets_np(t, t, cfg.num_buckets, cfg.max_distance)).to(x.device)
    position_bias = m.encoder.layers[0].attention.rel_attn_embed(buckets).permute(2, 0, 1)
    hidden = [x]
    for layer in m.encoder.layers[:upto]:
        x = _encoder_layer(layer, x, position_bias, cfg)
        hidden.append(x)
    return hidden


def wavlm_features(m: WavLM, wave: torch.Tensor, segment_size: int = 320) -> torch.Tensor:
    """extract_hubert_feature (module/hubert.py:15-22): (h[4] + h[9]) / 2,
    linearly interpolated to ``L // segment_size`` frames.  wave [N, L] ->
    [N, L // 320, hidden].  Layers past the 9th are not run."""
    hs = wavlm_hidden_states(m, wave, upto=9)
    feat = (hs[4] + hs[9]) * 0.5
    return linear_interpolate(feat, wave.shape[1] // segment_size, axis=1)


# ---------------------------------------------------------------------------
# state dicts
# ---------------------------------------------------------------------------

_PC = "encoder.pos_conv_embed.conv"


def hf_state(sd: Mapping[str, object]) -> dict:
    """A Hugging Face ``WavLMModel`` state dict (numpy or torch values) in
    this module's keys: ``weight_g`` / ``weight_v`` renamed to the
    parametrization's ``original0`` / ``original1``, the unused keys left
    out."""
    rename = {f"{_PC}.weight_g": f"{_PC}.parametrizations.weight.original0",
              f"{_PC}.weight_v": f"{_PC}.parametrizations.weight.original1"}
    return {rename.get(k, k): v for k, v in sd.items() if k not in UNUSED_KEYS}


def import_wavlm(sd: Mapping[str, object]) -> WavLM:
    """A ``WavLM`` on the CPU in eval mode with no gradient, from a Hugging
    Face state dict in either weight-norm form, loaded with strict key
    matching, at the widths the state dict holds (``compat/weights.py:
    wavlm_config``)."""
    from alivevc_tpu_torch.compat.weights import wavlm_config   # it imports this module

    sd = hf_state(sd)
    with torch.device("meta"):      # no random initialisation: every tensor is assigned
        m = WavLM(wavlm_config(sd))
    m.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                       for k, v in sd.items()}, strict=True, assign=True)
    return m.eval().requires_grad_(False)


def seeded_state(cfg: WavLMConfig = WavLMConfig(), seed: int = 0,
                 legacy_weight_norm: bool = False) -> dict:
    """A Hugging Face WavLM state dict of numpy float32 arrays drawn from
    ``seed`` (no checkpoint of the real teacher is at hand): matrices and
    convs N(0, 1 / fan_in), norm scales and ``gru_rel_pos_const`` 1 +
    N(0, 0.1^2), biases N(0, 0.05^2), the positional conv's g 1 + U(0, 0.1).
    ``legacy_weight_norm`` names the positional conv ``weight_g`` /
    ``weight_v`` (``torch.nn.utils.weight_norm``) instead of the
    parametrization's keys."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in WavLM(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("original0"):
            v = 1.0 + 0.1 * rng.random(shape, dtype=np.float32)
        elif len(shape) >= 2 and not k.endswith("gru_rel_pos_const"):
            v = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(int(np.prod(shape[1:])))
        elif k.endswith(("norm.weight", "gru_rel_pos_const")):
            v = 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            v = 0.05 * rng.standard_normal(shape, dtype=np.float32)
        sd[k] = v.astype(np.float32)
    if legacy_weight_norm:
        sd[f"{_PC}.weight_g"] = sd.pop(f"{_PC}.parametrizations.weight.original0")
        sd[f"{_PC}.weight_v"] = sd.pop(f"{_PC}.parametrizations.weight.original1")
    return sd
