"""The plain reference of RVC v2 at 40 kHz (Retrieval-based Voice Conversion,
github.com/RVC-Project/Retrieval-based-Voice-Conversion-WebUI): its inference
path infer/modules/vc/pipeline.py (``Pipeline.pipeline``, ``Pipeline.vc``)
with the synthesizer ``SynthesizerTrnMs768NSFsid`` (infer/lib/infer_pack/
models.py, attentions.py, modules.py) and fairseq's HuBERT-base read at
``output_layer=12``.  Plain PyTorch in float32 with TF32 off
(``numerics.exact_float32``), every product's operands through a
``numerics.Math``; NumPy and scipy in float64 where RVC uses them (the
high-pass, the cut search).  No kernel, no batching: each segment whole.

  * HuBERT-base (Hugging Face ``HubertModel(HubertConfig())``'s
    ``last_hidden_state``): 7 bias-free convs, a per-channel norm over time
    after the first, GELU; LayerNorm and projection; the weight-normed
    grouped positional conv (last frame dropped, GELU) added; the encoder's
    LayerNorm; 12 post-LN layers of plain attention.
  * Retrieval: the exhaustive L2 top 8 over every index row (squared
    distances |q|^2 + |x|^2 - 2 q.x, as faiss's flat index forms them; ties
    by ``torch.topk``), weights (1 / d)^2 normalised, with d the rows' exact
    squared distances |q - x|^2, blended at ``index_rate``; doubled to 100
    frames a second (nearest); ``protect`` where f0 < 1.
  * The prior and flow as attentions.py writes them: relative logits and
    weights through the [T, 2T - 1] layouts (``_relative_position_to_
    absolute_position`` and its inverse), channels first.
  * The NSF generator with SineGen written as RVC writes it.
  * The driver: the 48 Hz Butterworth ``filtfilt``, the moving sum of |x|
    summed 160 times as RVC's loop does, the cuts, 1 s of reflected padding,
    the segments' slices, and 1 s trimmed from each 40 kHz output.

Departures from RVC, each deliberate:
  * the F0 curve is given (RVC's ``f0_file`` path, here at 100 frames a
    second over the whole file and mirrored through the padding as the audio
    is); no pitch extractor runs.  The coarse pitch is computed in float64;
  * the exact search replaces the ``IVF{n},Flat`` index RVC ships (whose
    nprobe 1 approximates it), and the blend's distances are recomputed from
    the gathered rows (faiss returns its expanded form's);
  * no draw for SineGen's random initial phase, which harmonic_num 0 zeroes;
    the prior's noise and the source's noise are drawn, in that order, from
    the caller's generator for each segment;
  * the 16 kHz input comes from ``dsp.resample`` (RVC reads files through
    ffmpeg's resampler); no ``rms_mix_rate``, no ``resample_sr``, no int16
    write; float32 throughout (RVC's fp16 mode is left out);
  * weight norm folded into plain weights (the positional conv keeps its g
    and v, as the checkpoint holds them).

Parameters are named as the published state dicts name them (Hugging Face
``HubertModel`` keys; RVC's ``enc_p.*``, ``flow.flows.*``, ``dec.*``,
``emb_g``), so that the program loads the same drawn tensors strictly
(``param_specs``, drawn by ``weights.draw``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import dsp
from reference.model import Spec
from reference.numerics import Math

PARTS = ("hubert", "knn", "prior", "vocoder")
EPS = 1e-5


class Precisions:
    """One ``Math`` for each part: 'hubert', 'knn', 'prior' (the prior and
    the flow), 'vocoder'."""

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


def _conv(prefix: str, cin: int, cout: int, k: int, gain: float = 1.0, bias: Optional[bool] = True) -> List[Spec]:
    """A conv's weight, and its bias: uniform as the weight (True), zero
    (None) or none (False)."""
    s = [_uniform(f"{prefix}.weight", (cout, cin, k), cin * k, gain)]
    if bias is None:
        return s + [(f"{prefix}.bias", (cout,), ("const", 0.0))]
    return s + ([_uniform(f"{prefix}.bias", (cout,), cin * k, gain)] if bias else [])


def _norm(prefix: str, c: int, names=("weight", "bias")) -> List[Spec]:
    return [(f"{prefix}.{names[0]}", (c,), ("const", 1.0)), (f"{prefix}.{names[1]}", (c,), ("const", 0.0))]


def hubert_specs(h: dict) -> List[Spec]:
    """HuBERT-base's parameters (Hugging Face ``HubertModel`` names without
    ``masked_spec_embed``, the positional conv in ``parametrizations.weight``
    form): uniform at 1 / sqrt(fan-in), norms at 1 and 0, the positional
    conv's g at the norm its v is expected to have."""
    d, ff = h["hidden_size"], h["intermediate_size"]
    s: List[Spec] = []
    cin = 1
    for i, (c, k) in enumerate(zip(h["conv_dim"], h["conv_kernel"])):
        s += _conv(f"feature_extractor.conv_layers.{i}.conv", cin, c, k, bias=h["conv_bias"])
        if i == 0:
            s += _norm(f"feature_extractor.conv_layers.{i}.layer_norm", c)
        cin = c
    s += _norm("feature_projection.layer_norm", cin)
    s += _linear("feature_projection.projection", cin, d)
    k, g = h["num_conv_pos_embeddings"], h["num_conv_pos_embedding_groups"]
    pc = "encoder.pos_conv_embed.conv"
    s += [(f"{pc}.bias", (d,), ("uniform", 1.0 / math.sqrt(d // g * k))),
          (f"{pc}.parametrizations.weight.original0", (1, 1, k), ("const", math.sqrt(d / (3.0 * k)))),
          (f"{pc}.parametrizations.weight.original1", (d, d // g, k), ("uniform", 1.0 / math.sqrt(d // g * k)))]
    s += _norm("encoder.layer_norm", d)
    for i in range(h["num_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s += _linear(f"{p}.attention.{name}", d, d)
        s += _norm(f"{p}.layer_norm", d)
        s += _linear(f"{p}.feed_forward.intermediate_dense", d, ff)
        s += _linear(f"{p}.feed_forward.output_dense", ff, d)
        s += _norm(f"{p}.final_layer_norm", d)
    return s


def synth_specs(s_: dict) -> List[Spec]:
    """The synthesizer's inference parameters (RVC's names, weight norm
    folded).  The prior and the flow: uniform at 1 / sqrt(fan-in) (the
    coupling layers' ``post`` too, which RVC zeroes before training: at zero
    the flow would be the identity), ``emb_pitch`` and ``emb_g`` N(0, 1) as
    nn.Embedding draws them, ``emb_rel_k``/``_v`` N(0, 1) / sqrt(d_head) as
    attentions.py draws them, norms at 1 and 0.  The generator's weights:
    uniform at sqrt(3 / fan-in) (LeCun's uniform law, a transposed conv's
    fan-in the C_in k / u inputs that reach one output), as for kNN-VC's
    vocoder, so that a random generator's voice does not fade; its biases
    zero, since at that law their DC drove the output into tanh's rails
    (AC RMS 0.03 about a mean of -0.98, 63 % of samples past 0.99, at one
    seed of two); ``conv_post`` at 1 / sqrt(fan-in), for room below the
    rails (AC RMS 0.18-0.25 by seed at the published widths on a sung
    glide; 0.28-0.40 with it at sqrt(3 / fan-in))."""
    c, f, heads = s_["hidden_channels"], s_["filter_channels"], s_["n_heads"]
    k, w, inter = s_["kernel_size"], s_["window_size"], s_["inter_channels"]
    gin = s_["gin_channels"]
    hd = c // heads
    s = _linear("enc_p.emb_phone", s_["phone_channels"], c)
    s += [("enc_p.emb_pitch.weight", (s_["pitch_bins"], c), ("normal", 1.0))]
    for i in range(s_["n_layers"]):
        e = "enc_p.encoder"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            s += _conv(f"{e}.attn_layers.{i}.{name}", c, c, 1)
        s += [(f"{e}.attn_layers.{i}.emb_rel_k", (1, 2 * w + 1, hd), ("normal", hd ** -0.5)),
              (f"{e}.attn_layers.{i}.emb_rel_v", (1, 2 * w + 1, hd), ("normal", hd ** -0.5))]
        s += _norm(f"{e}.norm_layers_1.{i}", c, ("gamma", "beta"))
        s += _conv(f"{e}.ffn_layers.{i}.conv_1", c, f, k) + _conv(f"{e}.ffn_layers.{i}.conv_2", f, c, k)
        s += _norm(f"{e}.norm_layers_2.{i}", c, ("gamma", "beta"))
    s += _conv("enc_p.proj", c, 2 * inter, 1)
    g = s_["generator"]
    gain = math.sqrt(3.0)
    ch = g["upsample_initial_channel"]
    s += [_uniform("dec.m_source.l_linear.weight", (1, 1), 1, gain), ("dec.m_source.l_linear.bias", (1,), ("const", 0.0))]
    rates = g["upsample_rates"]
    for i, (u, kk) in enumerate(zip(rates, g["upsample_kernel_sizes"])):
        stride = math.prod(rates[i + 1:])
        s += _conv(f"dec.noise_convs.{i}", 1, ch // 2, 2 * stride if stride > 1 else 1, gain, None)
        ch //= 2
    s += _conv("dec.conv_pre", g["initial_channel"], g["upsample_initial_channel"], 7, gain, None)
    ch = g["upsample_initial_channel"]
    res = 0
    for i, (u, kk) in enumerate(zip(rates, g["upsample_kernel_sizes"])):
        fan = ch * kk // u
        s += [_uniform(f"dec.ups.{i}.weight", (ch, ch // 2, kk), fan, gain),
              (f"dec.ups.{i}.bias", (ch // 2,), ("const", 0.0))]
        ch //= 2
        for kr, dils in zip(g["resblock_kernel_sizes"], g["resblock_dilation_sizes"]):
            for j in range(len(dils)):
                s += _conv(f"dec.resblocks.{res}.convs1.{j}", ch, ch, kr, gain, None)
            for j in range(len(dils)):
                s += _conv(f"dec.resblocks.{res}.convs2.{j}", ch, ch, kr, gain, None)
            res += 1
    s += _conv("dec.conv_post", ch, 1, 7, bias=False)
    s += _conv("dec.cond", gin, g["upsample_initial_channel"], 1, gain, None)
    for i in range(0, 2 * s_["n_flows"], 2):
        p = f"flow.flows.{i}"
        s += _conv(f"{p}.pre", inter // 2, c, 1)
        s += _conv(f"{p}.enc.cond_layer", gin, 2 * c * s_["flow_layers"], 1)
        for j in range(s_["flow_layers"]):
            s += _conv(f"{p}.enc.in_layers.{j}", c, 2 * c, s_["flow_kernel_size"])
            s += _conv(f"{p}.enc.res_skip_layers.{j}", c, 2 * c if j < s_["flow_layers"] - 1 else c, 1)
        s += _conv(f"{p}.post", c, inter // 2, 1)
    s += [("emb_g.weight", (s_["spk_embed_dim"], gin), ("normal", 1.0))]
    return s


def param_specs(model: dict) -> Dict[str, List[Spec]]:
    """{'hubert': [...], 'synth': [...]} from a configuration's ``model``."""
    return {"hubert": hubert_specs(model["hubert"]), "synth": synth_specs(model["synthesizer"])}


# ---------------------------------------------------------------------------
# HuBERT-base
# ---------------------------------------------------------------------------


def _lin(m: Math, p, name: str, x: torch.Tensor) -> torch.Tensor:
    return m.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def _ln(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], EPS)


def hubert(m: Math, p, h: dict, wave: torch.Tensor) -> torch.Tensor:
    """wave [N, L] at 16 kHz -> the last layer's output [N, T, hidden]."""
    x = wave.float()[:, :, None]                                           # [N, L, 1]
    for i, stride in enumerate(h["conv_stride"]):
        pre = f"feature_extractor.conv_layers.{i}"
        x = m.conv1d(x, p[f"{pre}.conv.weight"], p.get(f"{pre}.conv.bias"), stride=stride)
        if i == 0:     # GroupNorm(C, C): each channel normalised over time
            mu = x.mean(dim=1, keepdim=True)
            var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
            x = (x - mu) / torch.sqrt(var + EPS) * p[f"{pre}.layer_norm.weight"] + p[f"{pre}.layer_norm.bias"]
        x = F.gelu(x)
    x = _lin(m, p, "feature_projection.projection", _ln(p, "feature_projection.layer_norm", x))
    pc = "encoder.pos_conv_embed.conv"
    gv, vv = p[f"{pc}.parametrizations.weight.original0"], p[f"{pc}.parametrizations.weight.original1"]
    weight = gv * vv / vv.norm(dim=(0, 1), keepdim=True)
    k = h["num_conv_pos_embeddings"]
    y = m.conv1d(x, weight, p[f"{pc}.bias"], padding=k // 2, groups=h["num_conv_pos_embedding_groups"])
    x = _ln(p, "encoder.layer_norm", x + F.gelu(y[:, :-1] if k % 2 == 0 else y))
    n, t, d = x.shape
    heads = h["num_heads"]
    hd = d // heads
    split = lambda y: y.reshape(n, t, heads, hd).transpose(1, 2)     # noqa: E731  [N, H, T, hd]
    for i in range(h["num_layers"]):
        pre = f"encoder.layers.{i}"
        q, kk, v = (split(_lin(m, p, f"{pre}.attention.{w}_proj", x)) for w in ("q", "k", "v"))
        a = m.mm(torch.softmax(m.mm(q, kk.transpose(-1, -2)) / math.sqrt(hd), dim=-1), v)
        a = _lin(m, p, f"{pre}.attention.out_proj", a.transpose(1, 2).reshape(n, t, d))
        x = _ln(p, f"{pre}.layer_norm", x + a)
        ffn = _lin(m, p, f"{pre}.feed_forward.output_dense",
                   F.gelu(_lin(m, p, f"{pre}.feed_forward.intermediate_dense", x)))
        x = _ln(p, f"{pre}.final_layer_norm", x + ffn)
    return x


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------


def retrieve(m: Math, feats: torch.Tensor, index: torch.Tensor, k: int, index_rate: float,
             rows: int = 1024) -> torch.Tensor:
    """feats [T, D] -> [T, D]: the exhaustive L2 top k of the index, RVC's
    inverse-square weights and blend."""
    xx = (index * index).sum(1)
    out = []
    for q0 in range(0, feats.shape[0], rows):
        q = feats[q0:q0 + rows].float()
        dist = (q * q).sum(1, keepdim=True) + xx[None] - 2.0 * m.mm(q, index.t())
        idx = torch.topk(dist, k, dim=1, largest=False).indices
        near = index[idx]                                                  # [t, k, D]
        d2 = ((q[:, None] - near) ** 2).sum(-1)
        w = torch.square(1.0 / d2)
        w = w / w.sum(dim=1, keepdim=True)
        out.append((near * w[..., None]).sum(1) * index_rate + (1 - index_rate) * q)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the prior and the flow (attentions.py, modules.py; channels first)
# ---------------------------------------------------------------------------


def _c1(m: Math, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], **kw) -> torch.Tensor:
    """Conv1d of x [N, Cin, T] channels first, operands through ``m``."""
    return F.conv1d(m.r(x), m.r(w), None if b is None else b.float(), **kw)


def _ln_c(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.transpose(1, -1), (x.shape[1],), p[f"{name}.gamma"], p[f"{name}.beta"],
                        EPS).transpose(1, -1)


def _rel_emb(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    padded = F.pad(emb, (0, 0, pad, pad)) if pad > 0 else emb
    return padded[:, start:start + 2 * length - 1]


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).view(b, h, t * 2 * t)
    return F.pad(x, (0, t - 1)).view(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).view(b, h, t * t + t * (t - 1))
    return F.pad(x, (t, 0)).view(b, h, t, 2 * t)[:, :, :, 1:]


def _attention(m: Math, p, name: str, x: torch.Tensor, heads: int, window: int) -> torch.Tensor:
    b, c, t = x.shape
    kc = c // heads
    q, k, v = (_c1(m, x, p[f"{name}.conv_{w}.weight"], p[f"{name}.conv_{w}.bias"]) for w in "qkv")
    q = q.view(b, heads, kc, t).transpose(2, 3) / math.sqrt(kc)
    k = k.view(b, heads, kc, t).transpose(2, 3)
    v = v.view(b, heads, kc, t).transpose(2, 3)
    scores = m.mm(q, k.transpose(-2, -1))
    rel_k = _rel_emb(p[f"{name}.emb_rel_k"], t, window)
    scores = scores + _rel_to_abs(m.mm(q, rel_k.unsqueeze(0).transpose(-2, -1)))
    prob = F.softmax(scores, dim=-1)
    out = m.mm(prob, v) + m.mm(_abs_to_rel(prob), _rel_emb(p[f"{name}.emb_rel_v"], t, window).unsqueeze(0))
    out = out.transpose(2, 3).contiguous().view(b, c, t)
    return _c1(m, out, p[f"{name}.conv_o.weight"], p[f"{name}.conv_o.bias"])


def prior(m: Math, p, s: dict, phone: torch.Tensor, pitch: torch.Tensor):
    """phone [1, T, 768], pitch [1, T] coarse -> (m_p, logs_p) [1, 192, T]."""
    c = s["hidden_channels"]
    x = m.mm(phone.float(), p["enc_p.emb_phone.weight"].t()) + p["enc_p.emb_phone.bias"]
    x = (x + p["enc_p.emb_pitch.weight"][pitch]) * math.sqrt(c)
    x = F.leaky_relu(x, 0.1).transpose(1, -1)
    pad = ((s["kernel_size"] - 1) // 2, s["kernel_size"] // 2)
    e = "enc_p.encoder"
    for i in range(s["n_layers"]):
        x = _ln_c(p, f"{e}.norm_layers_1.{i}", x + _attention(m, p, f"{e}.attn_layers.{i}", x, s["n_heads"],
                                                              s["window_size"]))
        f = f"{e}.ffn_layers.{i}"
        y = torch.relu(_c1(m, F.pad(x, pad), p[f"{f}.conv_1.weight"], p[f"{f}.conv_1.bias"]))
        y = _c1(m, F.pad(y, pad), p[f"{f}.conv_2.weight"], p[f"{f}.conv_2.bias"])
        x = _ln_c(p, f"{e}.norm_layers_2.{i}", x + y)
    stats = _c1(m, x, p["enc_p.proj.weight"], p["enc_p.proj.bias"])
    return stats[:, :s["inter_channels"]], stats[:, s["inter_channels"]:]


def flow_reverse(m: Math, p, s: dict, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ResidualCouplingBlock(reverse=True): for flow in reversed(flows):
    Flip, then the mean-only coupling layer taken back."""
    h, n, kf = s["hidden_channels"], s["flow_layers"], s["flow_kernel_size"]
    for i in reversed(range(0, 2 * s["n_flows"], 2)):
        z = torch.flip(z, [1])
        pre = f"flow.flows.{i}"
        x0, x1 = torch.split(z, [z.shape[1] // 2] * 2, 1)
        x = _c1(m, x0, p[f"{pre}.pre.weight"], p[f"{pre}.pre.bias"])
        gl = _c1(m, g, p[f"{pre}.enc.cond_layer.weight"], p[f"{pre}.enc.cond_layer.bias"])
        out = torch.zeros_like(x)
        for j in range(n):
            d = s["flow_dilation_rate"] ** j
            x_in = _c1(m, x, p[f"{pre}.enc.in_layers.{j}.weight"], p[f"{pre}.enc.in_layers.{j}.bias"],
                       dilation=d, padding=(kf * d - d) // 2)
            a = x_in + gl[:, j * 2 * h:(j + 1) * 2 * h]
            acts = torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:])
            rs = _c1(m, acts, p[f"{pre}.enc.res_skip_layers.{j}.weight"], p[f"{pre}.enc.res_skip_layers.{j}.bias"])
            if j < n - 1:
                x = x + rs[:, :h]
                out = out + rs[:, h:]
            else:
                out = out + rs
        mean = _c1(m, out, p[f"{pre}.post.weight"], p[f"{pre}.post.bias"])
        z = torch.cat([x0, (x1 - mean) * torch.exp(-torch.zeros_like(mean))], 1)
    return z


# ---------------------------------------------------------------------------
# the NSF generator (models.py: SineGen, SourceModuleHnNSF, GeneratorNSF)
# ---------------------------------------------------------------------------


def sine_gen(f0: torch.Tensor, upp: int, sr: int, noise: torch.Tensor, sine_amp: float = 0.1,
             noise_std: float = 0.003) -> torch.Tensor:
    """SineGen(harmonic_num=0).forward(f0 [1, T], upp) with the draw given:
    [1, T * upp, 1]."""
    f0 = f0[:, None].transpose(1, 2)
    f0_buf = torch.zeros(f0.shape[0], f0.shape[1], 1, device=f0.device)
    f0_buf[:, :, 0] = f0[:, :, 0]
    rad_values = (f0_buf / sr) % 1
    tmp_over_one = torch.cumsum(rad_values, 1)
    tmp_over_one *= upp
    tmp_over_one = F.interpolate(tmp_over_one.transpose(2, 1), scale_factor=float(upp), mode="linear",
                                 align_corners=True).transpose(2, 1)
    rad_values = F.interpolate(rad_values.transpose(2, 1), scale_factor=float(upp), mode="nearest").transpose(2, 1)
    tmp_over_one %= 1
    tmp_over_one_idx = (tmp_over_one[:, 1:, :] - tmp_over_one[:, :-1, :]) < 0
    cumsum_shift = torch.zeros_like(rad_values)
    cumsum_shift[:, 1:, :] = tmp_over_one_idx * -1.0
    sine_waves = torch.sin(torch.cumsum(rad_values + cumsum_shift, dim=1) * 2 * torch.pi)
    sine_waves = sine_waves * sine_amp
    uv = torch.ones_like(f0) * (f0 > 0)
    uv = F.interpolate(uv.transpose(2, 1), scale_factor=float(upp), mode="nearest").transpose(2, 1)
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    return sine_waves * uv + noise_amp * noise


def generator(m: Math, p, g_: dict, x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """GeneratorNSF.forward(x [1, 192, T], f0 [1, T], g [1, 256, 1]) ->
    [1, T * 400]."""
    rates, kernels = g_["upsample_rates"], g_["upsample_kernel_sizes"]
    upp = math.prod(rates)
    sine = sine_gen(f0, upp, g_["sample_rate"], noise, g_["sine_amp"], g_["noise_std"])
    har = torch.tanh(sine * p["dec.m_source.l_linear.weight"][0, 0] + p["dec.m_source.l_linear.bias"][0])
    har = har.transpose(1, 2)                                              # [1, 1, T * 400]
    x = _c1(m, x, p["dec.conv_pre.weight"], p["dec.conv_pre.bias"], padding=3)
    x = x + _c1(m, g, p["dec.cond.weight"], p["dec.cond.bias"])
    slope = g_["lrelu_slope"]
    n_k = len(g_["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, kernels)):
        x = F.leaky_relu(x, slope)
        x = F.conv_transpose1d(m.r(x), m.r(p[f"dec.ups.{i}.weight"]), p[f"dec.ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        stride = math.prod(rates[i + 1:])
        if stride > 1:
            xs = _c1(m, har, p[f"dec.noise_convs.{i}.weight"], p[f"dec.noise_convs.{i}.bias"], stride=stride,
                     padding=stride // 2)
        else:
            xs = _c1(m, har, p[f"dec.noise_convs.{i}.weight"], p[f"dec.noise_convs.{i}.bias"])
        x = x + xs
        acc = None
        for j, (kr, dils) in enumerate(zip(g_["resblock_kernel_sizes"], g_["resblock_dilation_sizes"])):
            pre, y = f"dec.resblocks.{i * n_k + j}", x
            for n, d in enumerate(dils):
                t = _c1(m, F.leaky_relu(y, slope), p[f"{pre}.convs1.{n}.weight"], p[f"{pre}.convs1.{n}.bias"],
                        dilation=d, padding=(kr * d - d) // 2)
                y = _c1(m, F.leaky_relu(t, slope), p[f"{pre}.convs2.{n}.weight"], p[f"{pre}.convs2.{n}.bias"],
                        padding=(kr - 1) // 2) + y
            if acc is None:
                acc = y
            else:
                acc += y
        x = acc / n_k
    x = _c1(m, F.leaky_relu(x), p["dec.conv_post.weight"], None, padding=3)
    return torch.tanh(x)[:, 0]


def synthesize(pr: Precisions, p, s: dict, feats: torch.Tensor, pitch: torch.Tensor, pitchf: torch.Tensor,
               sid: int, gen: Optional[torch.Generator]) -> torch.Tensor:
    """SynthesizerTrnMs768NSFsid.infer: feats [1, T, 768], pitch [1, T]
    coarse, pitchf [1, T] Hz -> [T * 400]; the prior's noise, then the
    source's, drawn from ``gen``."""
    g = p["emb_g.weight"][sid][None, :, None]
    m_p, logs_p = prior(pr["prior"], p, s, feats, pitch)
    eps = torch.randn(m_p.shape, generator=gen, device=m_p.device)
    z_p = m_p + torch.exp(logs_p) * eps * s["noise_scale"]
    z = flow_reverse(pr["prior"], p, s, z_p, g)
    g_ = s["generator"]
    noise = torch.randn((1, z.shape[2] * math.prod(g_["upsample_rates"]), 1), generator=gen, device=z.device)
    return generator(pr["vocoder"], p, g_, z, pitchf, g, noise)[0]


# ---------------------------------------------------------------------------
# the driver (Pipeline.pipeline, Pipeline.vc, Pipeline.get_f0)
# ---------------------------------------------------------------------------


def highpass(audio: np.ndarray, d: dict, sr: int = 16_000) -> np.ndarray:
    from scipy import signal

    bh, ah = signal.butter(N=d["highpass_order"], Wn=d["highpass_hz"], btype="high", fs=sr)
    return signal.filtfilt(bh, ah, audio)


def moving_sum(audio: np.ndarray, window: int) -> np.ndarray:
    """RVC's ``audio_sum``: |x| of the window/2-reflect-padded audio summed
    over ``window`` shifts, one after another, in float64."""
    audio_pad = np.pad(audio, (window // 2, window // 2), mode="reflect")
    audio_sum = np.zeros_like(audio)
    for i in range(window):
        audio_sum += np.abs(audio_pad[i:i - window])
    return audio_sum


def cuts(audio: np.ndarray, d: dict, sr: int = 16_000) -> list:
    """``opt_ts``: the cut near every x_center s of a file over x_max s."""
    window = d["window"]
    t_query, t_center, t_max = sr * d["x_query"], sr * d["x_center"], sr * d["x_max"]
    if audio.shape[0] + window // 2 * 2 <= t_max:
        return []
    audio_sum = moving_sum(audio, window)
    out = []
    for t in range(t_center, audio.shape[0], t_center):
        part = np.abs(audio_sum[t - t_query:t + t_query])
        out.append(t - t_query + np.where(part == part.min())[0][0])
    return out


def near_tie(audio: np.ndarray, d: dict, mine: Sequence[int], theirs: Sequence[int], rel: float,
             sr: int = 16_000) -> bool:
    """Whether every cut where ``theirs`` differs from ``mine`` (after the
    floor to a frame) is a near-tie of the moving sums: the two within
    ``rel`` of each other, relative.  Two lists of different lengths are
    not."""
    window = d["window"]
    if len(mine) != len(theirs):
        return False
    total = moving_sum(audio, window)
    for a, b in zip(mine, theirs):
        if a // window == b // window:
            continue
        if not 0 <= b < total.shape[0] or abs(total[a] - total[b]) > rel * max(abs(total[a]), abs(total[b])):
            return False
    return True


def pitch_curve(f0: np.ndarray, samples: int, d: dict, s: dict, sr: int = 16_000):
    """(pitchf [P] float32 Hz, pitch [P] int64 coarse) of the padded audio's
    frames: the curve (``samples // window`` frames, cut or zero-extended),
    reflected through the x_pad s of padding; get_f0's coarse mapping in
    float64."""
    window = d["window"]
    n = samples // window
    curve = np.zeros(n, np.float32)
    c = np.asarray(f0, np.float32).reshape(-1)[:n]
    curve[:c.shape[0]] = c
    pad = sr * d["x_pad"] // window
    f0p = np.pad(curve, (pad, pad), mode="reflect")
    f0_mel_min = 1127 * np.log(1 + d["f0_min"] / 700)
    f0_mel_max = 1127 * np.log(1 + d["f0_max"] / 700)
    f0_mel = 1127 * np.log(1 + f0p.astype(np.float64) / 700)
    f0_mel[f0_mel > 0] = (f0_mel[f0_mel > 0] - f0_mel_min) * 254 / (f0_mel_max - f0_mel_min) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > 255] = 255
    return f0p, np.rint(f0_mel).astype(np.int64)


def vc(pr: Precisions, p: dict, model: dict, audio0: torch.Tensor, pitch: torch.Tensor, pitchf: torch.Tensor,
       index: torch.Tensor, gen) -> torch.Tensor:
    """Pipeline.vc of one segment [L] on the device -> [T * 400]."""
    d, s = model["driver"], model["synthesizer"]
    feats = hubert(pr["hubert"], p["hubert"], model["hubert"], audio0.float()[None])
    feats0 = feats.clone()
    feats = retrieve(pr["knn"], feats[0], index, d["k"], d["index_rate"])[None]
    feats = F.interpolate(feats.permute(0, 2, 1), scale_factor=2).permute(0, 2, 1)
    feats0 = F.interpolate(feats0.permute(0, 2, 1), scale_factor=2).permute(0, 2, 1)
    p_len = audio0.shape[0] // d["window"]
    if feats.shape[1] < p_len:
        p_len = feats.shape[1]
        pitch, pitchf = pitch[:p_len], pitchf[:p_len]
    pitchff = pitchf.clone()
    pitchff[pitchf > 0] = 1
    pitchff[pitchf < 1] = d["protect"]
    pitchff = pitchff[None, :, None]
    feats = feats * pitchff + feats0 * (1 - pitchff)
    return synthesize(pr, p["synth"], s, feats, pitch[None], pitchf[None], d["sid"], gen)


def pipeline(pr: Precisions, p: dict, model: dict, audio: np.ndarray, f0: np.ndarray, index: torch.Tensor,
             gen, device, opt_ts: Optional[list] = None) -> np.ndarray:
    """Pipeline.pipeline of a 16 kHz file (float32, normalised as
    vc_single does) with its F0 curve -> 40 kHz float32; ``opt_ts`` in
    place of the cuts found (a near-tie's other choice)."""
    d = model["driver"]
    sr, window, tgt_sr = model["sample_rate"], d["window"], model["synthesizer"]["generator"]["sample_rate"]
    t_pad = sr * d["x_pad"]
    t_pad2, t_pad_tgt = 2 * t_pad, tgt_sr * d["x_pad"]
    audio = highpass(audio, d, sr)
    if opt_ts is None:
        opt_ts = cuts(audio, d, sr)
    audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
    pitchf, pitch = pitch_curve(f0, audio.shape[0], d, model["synthesizer"], sr)
    dev_audio = torch.from_numpy(audio_pad.astype(np.float32)).to(device)
    pitch = torch.from_numpy(pitch).to(device)
    pitchf = torch.from_numpy(pitchf).to(device)
    s, t, out = 0, None, []
    for t in opt_ts:
        t = t // window * window
        out.append(vc(pr, p, model, dev_audio[s:t + t_pad2 + window], pitch[s // window:(t + t_pad2) // window],
                      pitchf[s // window:(t + t_pad2) // window], index, gen)[t_pad_tgt:-t_pad_tgt])
        s = t
    out.append(vc(pr, p, model, dev_audio[t:] if t is not None else dev_audio,
                  pitch[t // window:] if t is not None else pitch,
                  pitchf[t // window:] if t is not None else pitchf, index, gen)[t_pad_tgt:-t_pad_tgt])
    return torch.cat(out).cpu().numpy()


def file_16k(wave: np.ndarray, sr: int, device) -> np.ndarray:
    """A file (mono, or channels on the shorter axis, mixed) at ``sr`` ->
    the 16 kHz float32 audio RVC converts, with vc_single's level guard."""
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=0 if wave.shape[0] <= wave.shape[1] else 1)
    x = dsp.resample(torch.as_tensor(wave, device=device)[None], sr, 16_000)[0].cpu().numpy()
    audio_max = np.abs(x).max() / 0.95
    return x / audio_max if audio_max > 1 else x


def index_rows(pr: Precisions, p: dict, model: dict, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The index: HuBERT's features of each training-set piece (16 kHz),
    one piece at a time, concatenated: [R, 768]."""
    return torch.cat([hubert(pr["hubert"], p["hubert"], model["hubert"], torch.as_tensor(w)[None].float())[0]
                      for w in pieces])
