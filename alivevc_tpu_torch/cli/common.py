"""Shared CLI helpers: model loading with ``.pt`` / ``.npz`` detection, the
reference's resume-by-existence convention (train_decoder.py:57-64), and the
target matrix both conversion CLIs build.

A model file is a reference-format ``.pt`` state dict (the reference's key
names, loaded with ``torch.load(weights_only=True)``) or the JAX package's
``.npz`` checkpoint (``io/checkpoint.py``, carried over by
``compat/weights.py``).  Either way the model is built at the widths the file
holds and loaded with strict key matching; a missing file gives a model
initialised from seed 0.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.infer.offline import build_target_matrix
from alivevc_tpu_torch.io.audio import read_wav
from alivevc_tpu_torch.io.checkpoint import load_checkpoint
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.ops.resample import resample


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
}


def reference_state(path: str, kind: str) -> dict:
    """The reference-format state dict of the model file at ``path``."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    return MODELS[kind][1](load_checkpoint(path))


def load_params_or_init(path: Optional[str], kind: str, device: torch.device) -> nn.Module:
    """The ``kind`` model from ``path`` if the file exists, else initialised
    from seed 0; in eval mode on ``device``."""
    cls, _, config_of = MODELS[kind]
    gen = torch.Generator().manual_seed(0)
    if path and os.path.exists(path):
        sd = reference_state(path, kind)
        module = weights.load_state(cls(config_of(sd), generator=gen), sd)
    else:
        module = cls(generator=gen)
    return module.to(device).eval().requires_grad_(False)


def resample_np(x: np.ndarray, orig: int, new: int, device: torch.device) -> np.ndarray:
    """``ops/resample.py`` on ``device`` for a host array."""
    if orig == new:
        return x
    return resample(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device),
                    orig, new).cpu().numpy()


def target_matrix(args, ce: nn.Module, device: torch.device, decimation: int = 1) -> torch.Tensor:
    """The target matrix of ``--target`` (first channel at 16 kHz,
    peak-normalised) and ``--voice-library-path``; "NONE" leaves one out."""
    target_wave = None
    if args.target != "NONE":
        w, sr = read_wav(args.target)
        w = resample_np(w[:1], sr, 16_000, device)
        peak = np.abs(w).max()
        if peak > 0:
            w = w / peak
        target_wave = w[0]
    tokens = None
    if args.voice_library_path != "NONE":
        tokens = load_params_or_init(args.voice_library_path, "voice_library", device).matrix()
    return build_target_matrix(ce, target_wave=target_wave, library_tokens=tokens,
                               decimation=decimation, device=device)


def log_logo() -> None:
    print("alivevc_tpu_torch — kNN voice conversion, the PyTorch/CUDA port of alivevc_tpu")
