"""The plain reference of kNN-VC (Baas, van Niekerk and Kamper, Interspeech
2023, arXiv:2305.18975; github.com/bshall/knn-vc): WavLM-Large read at the
output of layer 6, the mean of the k = 4 matching-set frames nearest by
cosine, and the prematched HiFi-GAN V1 generator at 16 kHz.  Plain PyTorch
in float32 with TF32 off (``numerics.exact_float32``), every product's
operands through a ``numerics.Math``, no kernels; the rank choice is
``paths.knn``'s.

WavLM follows Hugging Face's ``WavLMModel`` with ``feat_extract_norm =
"layer"`` and ``do_stable_layer_norm = True`` (microsoft/wavlm-large): a
LayerNorm over channels after every conv of the front end, conv biases,
pre-LN layers whose gate reads the normed input, and ``hidden_states[6]``
taken as layer 6 returns it, before any final norm (kNN-VC's
``extract_features(output_layer=6)``).  The bucket table is computed in
float64 NumPy.  The generator follows knn-vc's hifigan/models.py.

Departures from kNN-VC, each deliberate:
  * no voice-activity trim of the matching set (``vad_trigger_level``) and
    no -16 LUFS gain on the output: both wait for a trained checkpoint;
  * weight norm folded into plain weights, as kNN-VC removes it before
    inference (the positional conv keeps its g and v, as the checkpoint
    holds them);
  * the output zero-padded or cut to the input's length (kNN-VC returns
    frames x 320 samples).

Parameters are named as the published state dicts name them, so that the
program loads the same drawn tensors strictly (``param_specs``, drawn by
``weights.draw``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import dsp, paths
from reference.model import Spec
from reference.numerics import Math

PARTS = ("wavlm", "knn", "vocoder")
EPS = 1e-5


class Precisions:
    """One ``Math`` for each part: 'wavlm', 'knn', 'vocoder'."""

    def __init__(self, modes: Optional[Dict[str, str]] = None):
        modes = modes or {}
        self.m = {part: Math(modes.get(part, "fp32")) for part in PARTS}

    def __getitem__(self, part: str) -> Math:
        return self.m[part]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _uniform(name: str, shape, fan_in: int, gain: float = 1.0) -> Spec:
    return (name, tuple(shape), ("uniform", gain / math.sqrt(fan_in)))


def _linear(prefix: str, cin: int, cout: int, gain: float = 1.0) -> List[Spec]:
    return [_uniform(f"{prefix}.weight", (cout, cin), cin, gain), _uniform(f"{prefix}.bias", (cout,), cin, gain)]


def _conv(prefix: str, cin: int, cout: int, k: int, groups: int = 1, gain: float = 1.0) -> List[Spec]:
    fan = cin // groups * k
    return [_uniform(f"{prefix}.weight", (cout, cin // groups, k), fan, gain),
            _uniform(f"{prefix}.bias", (cout,), fan, gain)]


def _norm(prefix: str, c: int) -> List[Spec]:
    return [(f"{prefix}.weight", (c,), ("const", 1.0)), (f"{prefix}.bias", (c,), ("const", 0.0))]


def wavlm_specs(w: dict) -> List[Spec]:
    """WavLM-Large's parameters (Hugging Face names, the positional conv in
    ``parametrizations.weight`` form) at the widths of ``w``; every layer is
    listed, as the checkpoint holds it.  Weights and biases uniform at
    1 / sqrt(fan-in); norms at 1 and 0; ``gru_rel_pos_const`` 1; the
    positional conv's g at the norm its v is expected to have, so that the
    folded weight keeps v's law."""
    d, h, ff = w["hidden_size"], w["num_heads"], w["intermediate_size"]
    s: List[Spec] = []
    cin = 1
    for i, (c, k) in enumerate(zip(w["conv_dim"], w["conv_kernel"])):
        s += _conv(f"feature_extractor.conv_layers.{i}.conv", cin, c, k)
        s += _norm(f"feature_extractor.conv_layers.{i}.layer_norm", c)
        cin = c
    s += _norm("feature_projection.layer_norm", cin)
    s += _linear("feature_projection.projection", cin, d)
    k, g = w["num_conv_pos_embeddings"], w["num_conv_pos_embedding_groups"]
    pc = "encoder.pos_conv_embed.conv"
    s += [(f"{pc}.bias", (d,), ("uniform", 1.0 / math.sqrt(d // g * k))),
          (f"{pc}.parametrizations.weight.original0", (1, 1, k), ("const", math.sqrt(d / (3.0 * k)))),
          (f"{pc}.parametrizations.weight.original1", (d, d // g, k), ("uniform", 1.0 / math.sqrt(d // g * k)))]
    s += _norm("encoder.layer_norm", d)
    for i in range(w["num_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s += _linear(f"{p}.attention.{name}", d, d)
        s += _linear(f"{p}.attention.gru_rel_pos_linear", d // h, 8)
        s += [(f"{p}.attention.gru_rel_pos_const", (1, h, 1, 1), ("const", 1.0))]
        if i == 0:
            s += [(f"{p}.attention.rel_attn_embed.weight", (w["num_buckets"], h), ("normal", 1.0))]
        s += _norm(f"{p}.layer_norm", d)
        s += _linear(f"{p}.feed_forward.intermediate_dense", d, ff)
        s += _linear(f"{p}.feed_forward.output_dense", ff, d)
        s += _norm(f"{p}.final_layer_norm", d)
    return s


def vocoder_specs(v: dict) -> List[Spec]:
    """The generator's parameters (knn-vc hifigan/models.py names, weight
    norm removed): uniform at sqrt(3 / fan-in) (LeCun's uniform law: a
    layer keeps its input's variance), where a transposed conv's fan-in is
    the inputs that reach one output sample (C_in k / u).  At PyTorch's
    default bound, 1 / sqrt(fan-in), a random generator's voice fades below
    1 % of full scale, and what is left of its output is the biases' DC."""
    g = math.sqrt(3.0)
    s = _linear("lin_pre", v["input_channels"], v["hidden_channels"], g)
    c = v["upsample_initial_channel"]
    s += _conv("conv_pre", v["hidden_channels"], c, 7, gain=g)
    res = 0
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        fan = c * k // u
        s += [_uniform(f"ups.{i}.weight", (c, c // 2, k), fan, g), _uniform(f"ups.{i}.bias", (c // 2,), fan, g)]
        c //= 2
        for kr, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            for j in range(len(dils)):
                s += _conv(f"resblocks.{res}.convs1.{j}", c, c, kr, gain=g)
            for j in range(len(dils)):
                s += _conv(f"resblocks.{res}.convs2.{j}", c, c, kr, gain=g)
            res += 1
    return s + _conv("conv_post", c, 1, 7, gain=g)


def param_specs(model: dict) -> Dict[str, List[Spec]]:
    """{'wavlm': [...], 'vocoder': [...]} from a configuration's ``model``."""
    return {"wavlm": wavlm_specs(model["wavlm"]), "vocoder": vocoder_specs(model["vocoder"])}


# ---------------------------------------------------------------------------
# WavLM-Large
# ---------------------------------------------------------------------------


def _lin(m: Math, p, name: str, x: torch.Tensor) -> torch.Tensor:
    return m.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def _ln(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], EPS)


def rel_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[t, t] T5-style log buckets of key - query, as WavLMAttention's
    ``_relative_positions_bucket``, the log taken in float64."""
    nb = num_buckets // 2
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    large = np.log(np.maximum(rel, 1).astype(np.float64) / exact) / math.log(max_distance / exact) * (nb - exact)
    large = np.minimum((exact + large).astype(np.int64), nb - 1)
    return out + np.where(rel < exact, rel, large)


def _attention(m: Math, p, name: str, x: torch.Tensor, bias: torch.Tensor, heads: int) -> torch.Tensor:
    n, t, d = x.shape
    hd = d // heads
    split = lambda y: y.reshape(n, t, heads, hd).transpose(1, 2)     # noqa: E731  [N, H, T, hd]
    g = _lin(m, p, f"{name}.gru_rel_pos_linear", split(x)).reshape(n, heads, t, 2, 4).sum(-1)
    a, b = torch.sigmoid(g).chunk(2, dim=-1)
    gate = a * (b * p[f"{name}.gru_rel_pos_const"] - 1.0) + 2.0           # [N, H, T, 1]
    q, k, v = (split(_lin(m, p, f"{name}.{w}_proj", x)) for w in ("q", "k", "v"))
    scores = m.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + gate * bias[None]
    out = m.mm(torch.softmax(scores, dim=-1), v)
    return _lin(m, p, f"{name}.out_proj", out.transpose(1, 2).reshape(n, t, d))


def hidden_states(m: Math, p, w: dict, wave: torch.Tensor, upto: int) -> List[torch.Tensor]:
    """wave [N, L] -> [x_0, ..., x_upto], each [N, T, hidden]: the encoder's
    input (the projected features plus the positional conv) and the output
    of each pre-LN layer up to ``upto``."""
    x = wave.float()[:, :, None]                                           # [N, L, 1]
    for i, stride in enumerate(w["conv_stride"]):
        pre = f"feature_extractor.conv_layers.{i}"
        x = m.conv1d(x, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"], stride=stride)
        x = F.gelu(_ln(p, f"{pre}.layer_norm", x))
    x = _lin(m, p, "feature_projection.projection", _ln(p, "feature_projection.layer_norm", x))
    pc = "encoder.pos_conv_embed.conv"
    gv, vv = p[f"{pc}.parametrizations.weight.original0"], p[f"{pc}.parametrizations.weight.original1"]
    weight = gv * vv / vv.norm(dim=(0, 1), keepdim=True)
    k = w["num_conv_pos_embeddings"]
    y = m.conv1d(x, weight, p[f"{pc}.bias"], padding=k // 2, groups=w["num_conv_pos_embedding_groups"])
    x = x + F.gelu(y[:, :-1] if k % 2 == 0 else y)
    t = x.shape[1]
    buckets = torch.from_numpy(rel_buckets(t, w["num_buckets"], w["max_distance"])).to(x.device)
    bias = p["encoder.layers.0.attention.rel_attn_embed.weight"][buckets].permute(2, 0, 1)   # [H, T, T]
    out = [x]
    for i in range(upto):
        pre = f"encoder.layers.{i}"
        x = x + _attention(m, p, f"{pre}.attention", _ln(p, f"{pre}.layer_norm", x), bias, w["num_heads"])
        h = _ln(p, f"{pre}.final_layer_norm", x)
        x = x + _lin(m, p, f"{pre}.feed_forward.output_dense",
                     F.gelu(_lin(m, p, f"{pre}.feed_forward.intermediate_dense", h)))
        out.append(x)
    return out


def features(m: Math, p, model: dict, wave: torch.Tensor) -> torch.Tensor:
    """One utterance [L] at 16 kHz -> [T, hidden]: the output of layer
    ``model['layer']``."""
    layer = model["layer"]
    return hidden_states(m, p, model["wavlm"], wave[None], layer)[layer][0]


# ---------------------------------------------------------------------------
# HiFi-GAN V1 generator (prematched)
# ---------------------------------------------------------------------------


def _conv_t(m: Math, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Transposed conv of channels-last x [N, T, Cin], w [Cin, Cout, k]."""
    y = F.conv_transpose1d(m.r(x).transpose(1, 2), m.r(w), b, stride=stride, padding=padding)
    return y.transpose(1, 2)


def vocoder(m: Math, p, v: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats [N, T, input_channels] -> waveform [N, T * prod(rates)]."""
    slope = v["lrelu_slope"]
    act = lambda y, s=slope: F.leaky_relu(y, s)        # noqa: E731
    x = _lin(m, p, "lin_pre", feats.float())
    x = m.conv1d(x, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    kernels = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = _conv_t(m, act(x), p[f"ups.{i}.weight"], p[f"ups.{i}.bias"], u, (k - u) // 2)
        acc = 0.0
        for j, (kr, dils) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])):
            pre, y = f"resblocks.{i * kernels + j}", x
            for n, d in enumerate(dils):
                t = m.conv1d(act(y), p[f"{pre}.convs1.{n}.weight"], p[f"{pre}.convs1.{n}.bias"],
                             padding=(kr * d - d) // 2, dilation=d)
                y = y + m.conv1d(act(t), p[f"{pre}.convs2.{n}.weight"], p[f"{pre}.convs2.{n}.bias"],
                                 padding=(kr - 1) // 2)
            acc = acc + y
        x = acc / kernels
    x = m.conv1d(act(x, 0.01), p["conv_post.weight"], p["conv_post.bias"], padding=3)
    return torch.tanh(x)[..., 0]


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def matching_set(pr: Precisions, p: dict, model: dict, waves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The features of each target utterance (16 kHz), one at a time,
    concatenated: [R, hidden]."""
    return torch.cat([features(pr["wavlm"], p["wavlm"], model, torch.as_tensor(w)) for w in waves])


def convert(pr: Precisions, p: dict, model: dict, wave: torch.Tensor, mset: torch.Tensor,
            knn_swap: Optional[torch.Tensor] = None):
    """One utterance [L] at 16 kHz -> (converted [L], the kNN margins [T]):
    features, the mean of the k nearest matching-set rows (no blend), the
    vocoder, padded or cut to L.  ``knn_swap`` [T] (bool) takes the
    (k+1)-th row in place of the k-th (``paths.knn``)."""
    feat = features(pr["wavlm"], p["wavlm"], model, wave)
    knn, margin = paths.knn(pr["knn"], feat, mset, model["knn"]["k"], 0.0, swap=knn_swap)
    out = vocoder(pr["vocoder"], p["vocoder"], model["vocoder"], knn[None])[0]
    n = wave.shape[0]
    out = out[:n] if out.shape[0] >= n else torch.cat([out, out.new_zeros(n - out.shape[0])])
    return out, margin


def convert_file(pr: Precisions, p: dict, model: dict, wave: np.ndarray, sr: int, mset: torch.Tensor,
                 device) -> np.ndarray:
    """A mono file at ``sr`` -> the converted file at ``sr`` (resampled to
    16 kHz and back where ``sr`` differs)."""
    sr16 = model["sample_rate"]
    x = dsp.resample(torch.as_tensor(np.asarray(wave, np.float32), device=device)[None], sr, sr16)[0]
    out, _ = convert(pr, p, model, x, mset)
    return dsp.resample(out[None], sr16, sr)[0].cpu().numpy()
