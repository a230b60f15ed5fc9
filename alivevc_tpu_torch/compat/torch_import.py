"""Reference checkpoints into the port's modules (the counterpart of
``alivevc_tpu/compat/torch_import.py``).

The port's modules hold the reference's state-dict names and layouts, so a
reference ``.pt`` (content_encoder.pt, f0_estimator.pt, decoder.pt,
discriminator.pt, voice_library.pt) *is* a module's state dict: importing
one builds the module at the widths the file holds
(``compat/weights.py:*_config``) and loads it with strict key matching.  The
JAX package's importers rewrite layouts instead; here nothing is rewritten.

``reference_state`` also reads the model of a kind out of a training state
``.pt`` of this package (``train/state.py``), out of the JAX package's
parameter checkpoint (``.npz`` / ``.ckpt``, carried over by
``compat/weights.py``), or out of a JAX training state
(``compat/jax_train_state.py:model_params``: the JAX trainers' default
outputs, e.g. ``content_encoder.ckpt``, are whole ``DistillState``s); a
file that holds no model of the kind is refused with a message naming it.
``load_params_or_init`` is the CLIs' loader, with the reference's
resume-by-existence convention: a missing file gives a seed-0 model.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from alivevc_tpu_torch.compat import jax_train_state, weights
from alivevc_tpu_torch.io.checkpoint import Fields, load_checkpoint
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.train.state import is_train_state

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pt`` state dict, on the CPU (``torch.load(weights_only=True)``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def import_content_encoder(sd) -> ContentEncoder:
    return weights.build("content_encoder", sd)


def import_f0_estimator(sd) -> F0Estimator:
    return weights.build("f0_estimator", sd)


def import_voice_library(sd) -> VoiceLibrary:
    return weights.build("voice_library", sd)


def import_decoder(sd) -> Decoder:
    return weights.build("decoder", sd)


def import_discriminator(sd) -> Discriminator:
    return weights.build("discriminator", sd)


def reference_state(path: str, kind: str) -> dict:
    """The reference-format state dict of the ``kind`` model in the file at
    ``path``: a reference ``.pt``, a training state ``.pt`` of this package,
    a JAX parameter tree, or a JAX training state (``.ckpt``)."""
    if path.endswith(".pt"):
        sd = load_torch_state_dict(path)
        if is_train_state(sd):
            if kind not in sd["models"]:
                raise ValueError(f"{path}: the training state holds no {kind}")
            return sd["models"][kind]
        return sd
    tree = load_checkpoint(path)
    if isinstance(tree, Fields):
        tree = jax_train_state.model_params(tree, kind, path)
    try:
        return weights.state_of(kind, tree)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_params_or_init(path: Optional[str], kind: str, device: torch.device) -> nn.Module:
    """The ``kind`` model from ``path`` if the file exists, else initialised
    from seed 0; in eval mode on ``device``."""
    if path and os.path.exists(path):
        module = weights.build(kind, reference_state(path, kind))
    else:
        module = weights.MODELS[kind].module(generator=torch.Generator().manual_seed(0))
    return module.to(device).eval().requires_grad_(False)
