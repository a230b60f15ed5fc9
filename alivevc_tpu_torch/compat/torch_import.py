"""Reference checkpoints into the port's modules (the counterpart of
``alivevc_tpu/compat/torch_import.py``).

The port's modules hold the reference's state-dict names and layouts, so a
reference ``.pt`` (content_encoder.pt, f0_estimator.pt, decoder.pt,
discriminator.pt, voice_library.pt) *is* a module's state dict: importing
one builds the module at the widths the file holds
(``compat/weights.py:*_config``) and loads it with strict key matching.  The
JAX package's importers rewrite layouts instead; here nothing is rewritten.

``reference_state`` also reads the model of a kind out of a training state
``.pt`` of this package (``train/state.py``) or out of the JAX package's
``.npz`` checkpoint (carried over by ``compat/weights.py``);
``load_params_or_init`` is the CLIs' loader, with the reference's
resume-by-existence convention: a missing file gives a seed-0 model.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.io.checkpoint import load_checkpoint
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.train.state import is_train_state

StateDict = Dict[str, torch.Tensor]


def _decoder_state(tree) -> dict:
    chans, rates = weights.filter_layout(tree)
    return weights.decoder_state(tree, DecoderConfig(filter_channels=chans, filter_rates=rates))


# kind -> (module class, JAX pytree -> reference state dict, state dict -> config)
MODELS = {
    "content_encoder": (ContentEncoder, weights.content_encoder_state,
                        weights.content_encoder_config),
    "f0_estimator": (F0Estimator, weights.f0_estimator_state, weights.f0_estimator_config),
    "decoder": (Decoder, _decoder_state, weights.decoder_config),
    "voice_library": (VoiceLibrary, weights.voice_library_state, weights.voice_library_config),
    "discriminator": (Discriminator, weights.discriminator_state, weights.discriminator_config),
}


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pt`` state dict, on the CPU (``torch.load(weights_only=True)``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _import(kind: str, sd) -> nn.Module:
    cls, _, config_of = MODELS[kind]
    return weights.load_state(cls(config_of(sd), generator=torch.Generator().manual_seed(0)), sd)


def import_content_encoder(sd) -> ContentEncoder:
    return _import("content_encoder", sd)


def import_f0_estimator(sd) -> F0Estimator:
    return _import("f0_estimator", sd)


def import_voice_library(sd) -> VoiceLibrary:
    return _import("voice_library", sd)


def import_decoder(sd) -> Decoder:
    return _import("decoder", sd)


def import_discriminator(sd) -> Discriminator:
    return _import("discriminator", sd)


def reference_state(path: str, kind: str) -> dict:
    """The reference-format state dict of the model file at ``path``."""
    if path.endswith(".pt"):
        sd = load_torch_state_dict(path)
        if is_train_state(sd):
            if kind not in sd["models"]:
                raise ValueError(f"{path}: the training state holds no {kind}")
            return sd["models"][kind]
        return sd
    return MODELS[kind][1](load_checkpoint(path))


def load_params_or_init(path: Optional[str], kind: str, device: torch.device) -> nn.Module:
    """The ``kind`` model from ``path`` if the file exists, else initialised
    from seed 0; in eval mode on ``device``."""
    if path and os.path.exists(path):
        module = _import(kind, reference_state(path, kind))
    else:
        module = MODELS[kind][0](generator=torch.Generator().manual_seed(0))
    return module.to(device).eval().requires_grad_(False)
