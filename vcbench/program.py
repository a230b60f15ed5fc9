"""The system under test, ``alivevc_tpu_torch``, built from a configuration
file and seeded weights.  The modules are made on the weights' device and
take the drawn tensors strictly, by the published parameter names."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def build_models(model: dict, params: Dict[str, Dict[str, torch.Tensor]]) -> Tuple:
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    dcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in model["decoder"].items()}
    with torch.device(next(iter(params["ce"].values())).device):
        mods = (ContentEncoder(ContentEncoderConfig(**model["content_encoder"])),
                F0Estimator(F0EstimatorConfig(**model["f0_estimator"])),
                Decoder(DecoderConfig(**dcfg)))
    for mod, key in zip(mods, ("ce", "f0", "dec")):
        mod.load_state_dict(params[key], strict=True)
        mod.eval().requires_grad_(False)
    return mods
