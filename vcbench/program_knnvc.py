"""The kNN-VC model of ``alivevc_tpu_torch`` built from a configuration
file and seeded weights: WavLM through the strict Hugging Face import
(``import_wavlm``, pre-LN given), the vocoder loaded strictly by its
published names.  The modules hold the drawn tensors, on their device."""

from __future__ import annotations

from typing import Dict

import torch


def build_model(model: dict, params: Dict[str, Dict[str, torch.Tensor]]):
    from alivevc_tpu_torch.config import HiFiGANConfig
    from alivevc_tpu_torch.infer.offline import KnnVC
    from alivevc_tpu_torch.models.hifigan import HiFiGAN
    from alivevc_tpu_torch.models.wavlm import WavLMConfig, import_wavlm

    w = {k: tuple(v) if isinstance(v, list) else v for k, v in model["wavlm"].items()}
    wavlm = import_wavlm(params["wavlm"], stable_layer_norm=w["do_stable_layer_norm"])
    if wavlm.cfg != WavLMConfig(**w):
        raise ValueError(f"the weights hold {wavlm.cfg}, the configuration asks for {WavLMConfig(**w)}")
    v = {k: tuple(tuple(x) if isinstance(x, list) else x for x in val) if isinstance(val, list) else val
         for k, val in model["vocoder"].items()}
    with torch.device("meta"):
        voc = HiFiGAN(HiFiGANConfig(**v))
    voc.load_state_dict(params["vocoder"], strict=True, assign=True)
    return KnnVC(wavlm, voc.eval().requires_grad_(False), model["layer"])
