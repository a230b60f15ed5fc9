"""Weight bridge: JAX parameter pytrees <-> the port's modules.

The JAX package keeps parameters as nested dicts of arrays in its own
layouts (pointwise ``w`` [Cin, Cout], conv ``w`` [k, Cin, Cout], depthwise
``w`` [k, C], down conv ``w`` [r*Cin, Cout], up conv ``w`` [Cin, r*Cout]).
The port's modules hold the reference's state-dict names and layouts, so the
bridge rewrites a pytree (any array type numpy can read) into a reference
state dict (``*_state``) and loads it with ``load_state_dict(strict=True)``.
The layout rules are this package's own copy of the JAX package's
``compat/torch_export.py``; either a reference checkpoint or a bridged JAX
pytree loads the same way.  ``*_params`` go back: a reference state dict to
the JAX pytree, in numpy, with JAX's dicts and lists (this package's own
copy of ``alivevc_tpu/compat/torch_import.py``'s ``import_*``).  Each rule
is a transpose or a reshape of one leaf, so an optimizer's moments, which
have the parameters' tree, go through the same functions.  ``MODELS`` ties
the five kinds to their modules and rules.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.config import (
    ContentEncoderConfig,
    DecoderConfig,
    DiscriminatorConfig,
    F0EstimatorConfig,
    VoiceLibraryConfig,
)
from alivevc_tpu_torch.io.checkpoint import flatten
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def lin_state(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _np(p["w"]).T[:, :, None]      # [out, in, 1]
    sd[f"{prefix}.bias"] = _np(p["b"])


def conv_state(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.transpose(_np(p["w"]), (2, 1, 0))   # [out, in, k]
    sd[f"{prefix}.bias"] = _np(p["b"])


def dw_state(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.transpose(_np(p["w"])[:, None, :], (2, 1, 0))   # [C, 1, k]
    sd[f"{prefix}.bias"] = _np(p["b"])


def norm_state(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.scale"] = _np(p["scale"])[None, :, None]
    sd[f"{prefix}.shift"] = _np(p["shift"])[None, :, None]


def convnext_state(sd: StateDict, prefix: str, p) -> None:
    dw_state(sd, f"{prefix}.dw_conv", p["dw_conv"])
    norm_state(sd, f"{prefix}.norm", p["norm"])
    lin_state(sd, f"{prefix}.pw_conv1", p["pw_conv1"])
    lin_state(sd, f"{prefix}.pw_conv2", p["pw_conv2"])
    sd[f"{prefix}.scale"] = _np(p["scale"])[None, :, None]


def adaptive_convnext_state(sd: StateDict, prefix: str, p) -> None:
    dw_state(sd, f"{prefix}.dw_conv", p["dw_conv"])
    lin_state(sd, f"{prefix}.norm.scale", p["norm"]["scale"])
    lin_state(sd, f"{prefix}.norm.shift", p["norm"]["shift"])
    lin_state(sd, f"{prefix}.pw_conv1", p["pw_conv1"])
    lin_state(sd, f"{prefix}.pw_conv2", p["pw_conv2"])
    sd[f"{prefix}.scale"] = _np(p["scale"])[None, :, None]


def content_encoder_state(params) -> StateDict:
    sd: StateDict = {}
    lin_state(sd, "input_layer", params["input_layer"])
    for i, blk in enumerate(params["mid_layers"]):
        convnext_state(sd, f"mid_layers.{i}", blk)
    lin_state(sd, "output_layer", params["output_layer"])
    return sd


def f0_estimator_state(params) -> StateDict:
    sd: StateDict = {}
    lin_state(sd, "input_layer", params["input_layer"])
    for i, blk in enumerate(params["mid_layers"]):
        convnext_state(sd, f"mid_layers.{i}", blk)
    norm_state(sd, "last_norm", params["last_norm"])
    lin_state(sd, "output_layer", params["output_layer"])
    return sd


def filter_block_state(sd: StateDict, prefix: str, blk) -> None:
    lin_state(sd, f"{prefix}.input_conv", blk["input_conv"])
    for d, rb in enumerate(blk["blocks"]):
        for name in ("c1", "c2"):
            mc = rb[name]
            conv_state(sd, f"{prefix}.blocks.{d}.{name}.conv.conv", mc["conv"])
            lin_state(sd, f"{prefix}.blocks.{d}.{name}.to_scale", mc["to_scale"])
            lin_state(sd, f"{prefix}.blocks.{d}.{name}.to_shift", mc["to_shift"])


def up_state(sd: StateDict, prefix: str, up, c_prev: int, c: int, r: int) -> None:
    w = _np(up["w"]).reshape(c_prev, r, c)                   # [cin, r, cout]
    sd[f"{prefix}.weight"] = np.transpose(w, (0, 2, 1))       # [cin, cout, r]
    sd[f"{prefix}.bias"] = _np(up["b"])


def decoder_state(params, cfg: DecoderConfig = DecoderConfig()) -> StateDict:
    sd: StateDict = {}
    fe = params["feature_extractor"]
    lin_state(sd, "feature_extractor.input_layer", fe["input_layer"])
    lin_state(sd, "feature_extractor.f0_enc.c1", fe["f0_enc"]["c1"])
    lin_state(sd, "feature_extractor.f0_enc.c2", fe["f0_enc"]["c2"])
    for i, blk in enumerate(fe["mid_layers"]):
        adaptive_convnext_state(sd, f"feature_extractor.mid_layers.{i}", blk)
    lin_state(sd, "harmonic_oscillator.to_amps", params["harmonic_oscillator"]["to_amps"])

    filt = params["filter"]
    conv_state(sd, "filter.source_in", filt["source_in"])
    chans = list(cfg.filter_channels)
    chan_nexts = chans[1:] + [chans[-1]]
    for i, (dp, c, c_next, r) in enumerate(zip(filt["downs"], chans, chan_nexts, cfg.filter_rates)):
        w = _np(dp["w"]).reshape(r, c, c_next)               # [r, cin, cout]
        sd[f"filter.downs.{i}.weight"] = np.transpose(w, (2, 1, 0))
        sd[f"filter.downs.{i}.bias"] = _np(dp["b"])
    conv_state(sd, "filter.mid_conv.conv", filt["mid_conv"])
    rchans = list(reversed(chans))
    chan_prevs = [rchans[0]] + rchans[:-1]
    for i, (up, c, c_prev, r) in enumerate(
        zip(filt["ups"], rchans, chan_prevs, reversed(list(cfg.filter_rates)))
    ):
        up_state(sd, f"filter.ups.{i}", up, c_prev, c, r)
    for i, blk in enumerate(filt["blocks"]):
        filter_block_state(sd, f"filter.blocks.{i}", blk)
    conv_state(sd, "filter.source_out", filt["source_out"])
    return sd


def voice_library_state(params) -> StateDict:
    return {"tokens": _np(params["tokens"]).T[None]}       # [1, 768, num_tokens]


def wn_conv2d_state(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight_v"] = np.transpose(_np(p["v"]), (3, 2, 0, 1))   # [out, in/g, kh, kw]
    sd[f"{prefix}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1, 1)
    sd[f"{prefix}.bias"] = _np(p["b"])


def discriminator_state(params) -> StateDict:
    """JAX discriminator pytree (``v`` [kh, kw, in/g, out], ``g`` [out]) ->
    the reference's MPD/MRD state dict."""
    sd: StateDict = {}
    for i, p in enumerate(params["mpd"]):
        pre = f"MPD.sub_discriminators.{i}"
        wn_conv2d_state(sd, f"{pre}.input_layer", p["input_layer"])
        for j, lp in enumerate(p["layers"]):
            wn_conv2d_state(sd, f"{pre}.layers.{j}", lp)
        wn_conv2d_state(sd, f"{pre}.final_conv", p["final_conv"])
        wn_conv2d_state(sd, f"{pre}.output_layer", p["output_layer"])
    for i, p in enumerate(params["mrd"]):
        pre = f"MRD.sub_discriminators.{i}"
        for j, lp in enumerate(p["layers"]):
            wn_conv2d_state(sd, f"{pre}.layers.{j}", lp)
        wn_conv2d_state(sd, f"{pre}.conv_post", p["conv_post"])
    return sd


def filter_layout(params):
    """(filter_channels, filter_rates) of a JAX decoder pytree, read off its
    down convs' shapes (``w`` [r * C_i, C_{i+1}]): what ``decoder_state``
    needs of the config."""
    filt = params["filter"]
    chans = [_np(filt["source_in"]["w"]).shape[2]]
    rates = []
    for dp in filt["downs"]:
        w = _np(dp["w"])
        rates.append(w.shape[0] // chans[-1])
        chans.append(w.shape[1])
    return tuple(chans[:-1]), tuple(rates)


# ---------------------------------------------------------------------------
# reference state dict -> JAX pytree (the inverses of the rules above)
# ---------------------------------------------------------------------------


def _leaf(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x))


def _lin(sd: Mapping, prefix: str) -> dict:
    return {"w": _leaf(_np(sd[f"{prefix}.weight"])[:, :, 0].T), "b": _leaf(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, prefix: str) -> dict:
    return {"w": _leaf(np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0))),
            "b": _leaf(sd[f"{prefix}.bias"])}


def _dw(sd: Mapping, prefix: str) -> dict:
    return {"w": _leaf(np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0))[:, 0, :]),
            "b": _leaf(sd[f"{prefix}.bias"])}


def _chan(x) -> np.ndarray:
    return _leaf(_np(x)[0, :, 0])


def _norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _chan(sd[f"{prefix}.scale"]), "shift": _chan(sd[f"{prefix}.shift"])}


def _convnext(sd: Mapping, prefix: str) -> dict:
    return {"dw_conv": _dw(sd, f"{prefix}.dw_conv"), "norm": _norm(sd, f"{prefix}.norm"),
            "pw_conv1": _lin(sd, f"{prefix}.pw_conv1"), "pw_conv2": _lin(sd, f"{prefix}.pw_conv2"),
            "scale": _chan(sd[f"{prefix}.scale"])}


def _adaptive_convnext(sd: Mapping, prefix: str) -> dict:
    return {"dw_conv": _dw(sd, f"{prefix}.dw_conv"),
            "norm": {"scale": _lin(sd, f"{prefix}.norm.scale"),
                     "shift": _lin(sd, f"{prefix}.norm.shift")},
            "pw_conv1": _lin(sd, f"{prefix}.pw_conv1"), "pw_conv2": _lin(sd, f"{prefix}.pw_conv2"),
            "scale": _chan(sd[f"{prefix}.scale"])}


def content_encoder_params(sd: Mapping) -> dict:
    return {"input_layer": _lin(sd, "input_layer"),
            "mid_layers": [_convnext(sd, f"mid_layers.{i}")
                           for i in range(_count(sd, "mid_layers.{}."))],
            "output_layer": _lin(sd, "output_layer")}


def f0_estimator_params(sd: Mapping) -> dict:
    return {"input_layer": _lin(sd, "input_layer"),
            "mid_layers": [_convnext(sd, f"mid_layers.{i}")
                           for i in range(_count(sd, "mid_layers.{}."))],
            "last_norm": _norm(sd, "last_norm"),
            "output_layer": _lin(sd, "output_layer")}


def _mod_causal(sd: Mapping, prefix: str) -> dict:
    return {"conv": _conv(sd, f"{prefix}.conv.conv"), "to_scale": _lin(sd, f"{prefix}.to_scale"),
            "to_shift": _lin(sd, f"{prefix}.to_shift")}


def decoder_params(sd: Mapping) -> dict:
    fe = "feature_extractor"
    downs, ups, blocks = [], [], []
    for i in range(_count(sd, "filter.downs.{}.")):
        w = _np(sd[f"filter.downs.{i}.weight"])                  # [out, in, r]
        downs.append({"w": _leaf(np.transpose(w, (2, 1, 0)).reshape(-1, w.shape[0])),
                      "b": _leaf(sd[f"filter.downs.{i}.bias"])})
        w = _np(sd[f"filter.ups.{i}.weight"])                    # [in, out, r]
        ups.append({"w": _leaf(np.transpose(w, (0, 2, 1)).reshape(w.shape[0], -1)),
                    "b": _leaf(sd[f"filter.ups.{i}.bias"])})
        pre = f"filter.blocks.{i}"
        blocks.append({"input_conv": _lin(sd, f"{pre}.input_conv"),
                       "blocks": [{"c1": _mod_causal(sd, f"{pre}.blocks.{d}.c1"),
                                   "c2": _mod_causal(sd, f"{pre}.blocks.{d}.c2")}
                                  for d in range(_count(sd, f"{pre}.blocks.{{}}."))]})
    return {
        "feature_extractor": {
            "input_layer": _lin(sd, f"{fe}.input_layer"),
            "f0_enc": {"c1": _lin(sd, f"{fe}.f0_enc.c1"), "c2": _lin(sd, f"{fe}.f0_enc.c2")},
            "mid_layers": [_adaptive_convnext(sd, f"{fe}.mid_layers.{i}")
                           for i in range(_count(sd, f"{fe}.mid_layers.{{}}."))],
        },
        "harmonic_oscillator": {"to_amps": _lin(sd, "harmonic_oscillator.to_amps")},
        "filter": {"source_in": _conv(sd, "filter.source_in"), "downs": downs,
                   "mid_conv": _conv(sd, "filter.mid_conv.conv"), "ups": ups, "blocks": blocks,
                   "source_out": _conv(sd, "filter.source_out")},
    }


def voice_library_params(sd: Mapping) -> dict:
    return {"tokens": _leaf(_np(sd["tokens"])[0].T)}          # [num_tokens, 768]


def _wn_conv2d(sd: Mapping, prefix: str) -> dict:
    return {"v": _leaf(np.transpose(_np(sd[f"{prefix}.weight_v"]), (2, 3, 1, 0))),
            "g": _leaf(_np(sd[f"{prefix}.weight_g"]).reshape(-1)),
            "b": _leaf(sd[f"{prefix}.bias"])}


def discriminator_params(sd: Mapping) -> dict:
    mpd, mrd = [], []
    for i in range(_count(sd, "MPD.sub_discriminators.{}.")):
        pre = f"MPD.sub_discriminators.{i}"
        mpd.append({"input_layer": _wn_conv2d(sd, f"{pre}.input_layer"),
                    "layers": [_wn_conv2d(sd, f"{pre}.layers.{j}")
                               for j in range(_count(sd, f"{pre}.layers.{{}}."))],
                    "final_conv": _wn_conv2d(sd, f"{pre}.final_conv"),
                    "output_layer": _wn_conv2d(sd, f"{pre}.output_layer")})
    for i in range(_count(sd, "MRD.sub_discriminators.{}.")):
        pre = f"MRD.sub_discriminators.{i}"
        mrd.append({"layers": [_wn_conv2d(sd, f"{pre}.layers.{j}")
                               for j in range(_count(sd, f"{pre}.layers.{{}}."))],
                    "conv_post": _wn_conv2d(sd, f"{pre}.conv_post")})
    return {"mpd": mpd, "mrd": mrd}


# ---------------------------------------------------------------------------
# configurations read off a reference state dict (the widths a checkpoint
# was trained at; what the config does not fix stays at its default)
# ---------------------------------------------------------------------------


def _count(sd: Mapping[str, np.ndarray], fmt: str) -> int:
    n = 0
    while any(k.startswith(fmt.format(n)) for k in sd):
        n += 1
    return n


def _convnext_widths(sd: Mapping[str, np.ndarray]) -> dict:
    w_in = sd["input_layer.weight"]                          # [internal, n_bins, 1]
    return dict(n_fft=2 * (w_in.shape[1] - 1), internal_channels=w_in.shape[0],
                hidden_channels=sd["mid_layers.0.pw_conv1.weight"].shape[0],
                output_channels=sd["output_layer.weight"].shape[0],
                num_layers=_count(sd, "mid_layers.{}."),
                kernel_size=sd["mid_layers.0.dw_conv.weight"].shape[2])


def content_encoder_config(sd: Mapping[str, np.ndarray]) -> ContentEncoderConfig:
    return ContentEncoderConfig(**_convnext_widths(sd))


def f0_estimator_config(sd: Mapping[str, np.ndarray]) -> F0EstimatorConfig:
    return F0EstimatorConfig(**_convnext_widths(sd))


def voice_library_config(sd: Mapping[str, np.ndarray]) -> VoiceLibraryConfig:
    _, dim, num_tokens = sd["tokens"].shape
    return VoiceLibraryConfig(num_tokens=num_tokens, dim=dim)


def discriminator_config(sd: Mapping[str, np.ndarray]) -> DiscriminatorConfig:
    """The widths of a reference discriminator state dict.  The periods and
    the resolutions' n_fft are not in the weights: a state dict with P
    period and R resolution sub-discriminators takes the first P and R of
    the defaults (the reference always has all eight and all three)."""
    d = DiscriminatorConfig()
    pre = "MPD.sub_discriminators.0"
    n_stages = _count(sd, f"{pre}.layers.{{}}.")
    v_in = sd[f"{pre}.input_layer.weight_v"]                  # [ch, 1, k, 1]
    stage_v = [sd[f"{pre}.layers.{j}.weight_v"] for j in range(n_stages)]
    cins = [v_in.shape[0]] + [v.shape[0] for v in stage_v[:-1]]
    groups = tuple(c // v.shape[1] for c, v in zip(cins, stage_v))
    return DiscriminatorConfig(
        periods=d.periods[:_count(sd, "MPD.sub_discriminators.{}.")],
        period_groups=groups + d.period_groups[len(groups):],
        period_channels=v_in.shape[0], period_kernel_size=v_in.shape[2],
        period_stages=n_stages, period_max_channels=max(v.shape[0] for v in stage_v),
        resolutions=d.resolutions[:_count(sd, "MRD.sub_discriminators.{}.")],
        resolution_channels=sd["MRD.sub_discriminators.0.layers.0.weight_v"].shape[0],
    )


def decoder_config(sd: Mapping[str, np.ndarray]) -> DecoderConfig:
    fe = "feature_extractor"
    w_in = sd[f"{fe}.input_layer.weight"]                    # [channels, content, 1]
    n_levels = _count(sd, "filter.downs.{}.")
    downs = [sd[f"filter.downs.{i}.weight"] for i in range(n_levels)]   # [out, in, r]
    return DecoderConfig(
        content_channels=w_in.shape[1], channels=w_in.shape[0],
        hidden_channels=sd[f"{fe}.mid_layers.0.pw_conv1.weight"].shape[0],
        num_layers=_count(sd, f"{fe}.mid_layers.{{}}."),
        kernel_size=sd[f"{fe}.mid_layers.0.dw_conv.weight"].shape[2],
        num_harmonics=sd["harmonic_oscillator.to_amps.weight"].shape[0],
        filter_rates=tuple(w.shape[2] for w in downs),
        filter_channels=tuple(w.shape[1] for w in downs),
        filter_kernel_size=sd["filter.mid_conv.conv.weight"].shape[2],
        filter_dilations=_count(sd, "filter.blocks.0.blocks.{}."),
    )


def load_state(module: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a reference-format state dict (numpy or torch values) with
    strict key matching, keeping the module's device and dtype."""
    p = next(module.parameters())
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)).to(p.device, p.dtype) for k, v in sd.items()},
        strict=True,
    )
    return module


def load_content_encoder(module: nn.Module, params) -> nn.Module:
    return load_state(module, content_encoder_state(params))


def load_f0_estimator(module: nn.Module, params) -> nn.Module:
    return load_state(module, f0_estimator_state(params))


def load_decoder(module: nn.Module, params, cfg: DecoderConfig = DecoderConfig()) -> nn.Module:
    return load_state(module, decoder_state(params, cfg))


def load_discriminator(module: nn.Module, params) -> nn.Module:
    return load_state(module, discriminator_state(params))


def load_voice_library(module: nn.Module, params) -> nn.Module:
    return load_state(module, voice_library_state(params))


def _decoder_state(params) -> StateDict:
    """``decoder_state`` at the filter layout the pytree holds."""
    chans, rates = filter_layout(params)
    return decoder_state(params, DecoderConfig(filter_channels=chans, filter_rates=rates))


class Kind(NamedTuple):
    module: type          # the port's module
    config_type: type     # its configuration
    state: Callable       # JAX pytree -> reference state dict
    params: Callable      # reference state dict -> JAX pytree
    config: Callable      # reference state dict -> the module's configuration


MODELS = {
    "content_encoder": Kind(ContentEncoder, ContentEncoderConfig, content_encoder_state,
                            content_encoder_params, content_encoder_config),
    "f0_estimator": Kind(F0Estimator, F0EstimatorConfig, f0_estimator_state,
                         f0_estimator_params, f0_estimator_config),
    "decoder": Kind(Decoder, DecoderConfig, _decoder_state, decoder_params, decoder_config),
    "voice_library": Kind(VoiceLibrary, VoiceLibraryConfig, voice_library_state,
                          voice_library_params, voice_library_config),
    "discriminator": Kind(Discriminator, DiscriminatorConfig, discriminator_state,
                          discriminator_params, discriminator_config),
}


def state_of(kind: str, params) -> StateDict:
    """``MODELS[kind].state(params)``, refusing a pytree that is not exactly
    a ``kind``'s: one that lacks a leaf the rules read, or holds one they do
    not (an F0 estimator's ``last_norm`` read as a content encoder's)."""
    m = MODELS[kind]
    try:
        sd = m.state(params)
    except (KeyError, TypeError) as e:
        raise ValueError(f"not a {kind}'s parameters: no {e}") from None
    extra = set(flatten(params)) - set(flatten(m.params(sd)))
    if extra:
        raise ValueError(f"not a {kind}'s parameters: {len(extra)} leaves the {kind} has no "
                         f"place for, e.g. {min(extra).replace(chr(31), '/')}")
    return sd


def build(kind: str, sd: Mapping) -> nn.Module:
    """The ``kind`` module at the widths the reference state dict ``sd``
    holds, loaded from it with strict key matching (on the CPU)."""
    m = MODELS[kind]
    return load_state(m.module(m.config(sd), generator=torch.Generator().manual_seed(0)), sd)


# ---------------------------------------------------------------------------
# WavLM (the distillation teacher): Hugging Face ``WavLMModel`` keys
# ---------------------------------------------------------------------------

_WAVLM_POS = "encoder.pos_conv_embed.conv"


def wavlm_state(params) -> StateDict:
    """The JAX package's WavLM pytree (``alivevc_tpu/models/wavlm.py:
    import_wavlm``'s output) -> a Hugging Face state dict in the port's
    keys (the positional conv's weight norm as ``parametrizations.weight.
    original0`` / ``original1``; no ``masked_spec_embed``)."""
    sd: StateDict = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = _np(p["w"]).T
        sd[f"{prefix}.bias"] = _np(p["b"])

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = _np(p["w"])
        sd[f"{prefix}.bias"] = _np(p["b"])

    for i, layer in enumerate(params["feature_encoder"]["conv_layers"]):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = np.transpose(_np(layer["conv"]["w"]), (2, 1, 0))
        if "b" in layer["conv"]:
            sd[f"{pre}.conv.bias"] = _np(layer["conv"]["b"])
        if "norm" in layer:
            ln(f"{pre}.layer_norm", layer["norm"])
    ln("feature_projection.layer_norm", params["fp_norm"])
    lin("feature_projection.projection", params["fp_proj"])
    pc = params["pos_conv"]
    sd[f"{_WAVLM_POS}.bias"] = _np(pc["b"])
    sd[f"{_WAVLM_POS}.parametrizations.weight.original0"] = np.transpose(_np(pc["g"]), (2, 1, 0))
    sd[f"{_WAVLM_POS}.parametrizations.weight.original1"] = np.transpose(_np(pc["v"]), (2, 1, 0))
    ln("encoder.layer_norm", params["enc_norm"])
    for i, layer in enumerate(params["layers"]):
        pre = f"encoder.layers.{i}"
        att = layer["attention"]
        sd[f"{pre}.attention.gru_rel_pos_const"] = _np(att["gru_rel_pos_const"])
        for name in ("k_proj", "v_proj", "q_proj", "out_proj", "gru_rel_pos_linear"):
            lin(f"{pre}.attention.{name}", att[name])
        if i == 0:
            sd[f"{pre}.attention.rel_attn_embed.weight"] = _np(params["rel_attn_embed"])
        ln(f"{pre}.layer_norm", layer["layer_norm"])
        lin(f"{pre}.feed_forward.intermediate_dense", layer["ff_in"])
        lin(f"{pre}.feed_forward.output_dense", layer["ff_out"])
        ln(f"{pre}.final_layer_norm", layer["final_layer_norm"])
    return sd


def wavlm_config(sd: Mapping[str, np.ndarray]):
    """The widths of a Hugging Face WavLM state dict (either weight-norm
    form): layers by count, hidden width from the feature projection, heads
    from ``gru_rel_pos_const``, the conv encoder's widths and taps, the
    positional conv's taps and groups from its v, the bucket count.  The
    strides, the bucket distance and the norms' eps are not in the weights
    and keep their defaults."""
    from alivevc_tpu_torch.models.wavlm import WavLMConfig

    n_conv = _count(sd, "feature_extractor.conv_layers.{}.")
    convs = [sd[f"feature_extractor.conv_layers.{i}.conv.weight"] for i in range(n_conv)]
    v = sd.get(f"{_WAVLM_POS}.parametrizations.weight.original1")
    if v is None:
        v = sd[f"{_WAVLM_POS}.weight_v"]                     # [C, C / groups, k]
    hidden = sd["feature_projection.projection.weight"].shape[0]
    d = WavLMConfig()
    return WavLMConfig(
        hidden_size=hidden,
        num_layers=_count(sd, "encoder.layers.{}."),
        num_heads=sd["encoder.layers.0.attention.gru_rel_pos_const"].shape[1],
        intermediate_size=sd["encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0],
        conv_dim=tuple(w.shape[0] for w in convs),
        conv_kernel=tuple(w.shape[2] for w in convs),
        conv_stride=d.conv_stride[:n_conv],
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
        num_conv_pos_embeddings=v.shape[2],
        num_conv_pos_embedding_groups=hidden // v.shape[1],
        num_buckets=sd["encoder.layers.0.attention.rel_attn_embed.weight"].shape[0],
    )
