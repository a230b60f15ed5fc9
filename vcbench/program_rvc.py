"""The RVC model of ``alivevc_tpu_torch`` built from a configuration file
and seeded weights: HuBERT through the strict Hugging Face import
(``import_wavlm``, its head count given), the synthesizer loaded strictly by
its published names, and the driver's settings.  The modules hold the drawn
tensors, on their device."""

from __future__ import annotations

from typing import Dict

import torch


def _tuples(d: dict) -> dict:
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v
            for k, v in d.items()}


def build_model(model: dict, params: Dict[str, Dict[str, torch.Tensor]]):
    """(``Rvc``, ``RvcInferenceConfig``)."""
    from alivevc_tpu_torch.config import NsfGeneratorConfig, RvcConfig, RvcInferenceConfig
    from alivevc_tpu_torch.infer.offline import Rvc
    from alivevc_tpu_torch.models.rvc import RvcSynthesizer
    from alivevc_tpu_torch.models.wavlm import WavLMConfig, import_wavlm

    h = _tuples(model["hubert"])
    hubert = import_wavlm(params["hubert"], stable_layer_norm=h["do_stable_layer_norm"], num_heads=h["num_heads"])
    if hubert.cfg != WavLMConfig(**h):
        raise ValueError(f"the weights hold {hubert.cfg}, the configuration asks for {WavLMConfig(**h)}")
    s = dict(model["synthesizer"])
    cfg = RvcConfig(**s | {"generator": NsfGeneratorConfig(**_tuples(s["generator"]))})
    with torch.device("meta"):
        synth = RvcSynthesizer(cfg)
    synth.load_state_dict(params["synth"], strict=True, assign=True)
    return Rvc(hubert, synth.eval().requires_grad_(False)), RvcInferenceConfig(**model["driver"])
