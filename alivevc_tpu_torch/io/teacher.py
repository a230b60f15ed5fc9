"""The WavLM teacher of content-encoder distillation (``alivevc_tpu/io/teacher.py``;
reference: module/hubert.py:6-22): frozen ``microsoft/wavlm-base-plus``, whose
feature is the mean of hidden states 4 and 9, linearly interpolated to
``L // 320`` frames.

The JAX package's teacher calls ``transformers.WavLMModel.from_pretrained``
with a hub name, which downloads the weights.  This one takes a local file
instead and runs the port's own ``models/wavlm.py`` on the card: the card's
machine has no network and no ``transformers``, and a file is what a user
keeps beside the corpus anyway.  The file is a ``WavLMModel`` state dict in
Hugging Face's keys (``.pt`` / ``.bin``, read with ``torch.load(...,
weights_only=True)``), either weight-norm form; the widths are read from it.
``precompute_teacher_features`` writes the features to ``.npz`` (key
``features``), the distillation CLI's ``--teacher-features`` input.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alivevc_tpu_torch.device import DeviceLike, resolve_device
from alivevc_tpu_torch.models.wavlm import import_wavlm, wavlm_features


class WavLMTeacher:
    """The frozen teacher (eval mode, no gradient) on ``device`` (the card
    unless ``device='cpu'``)."""

    def __init__(self, checkpoint: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        self.model = import_wavlm(sd).to(self.device)

    @torch.no_grad()
    def extract(self, wave, segment_size: int = 320) -> torch.Tensor:
        """wave [N, L] at 16 kHz (numpy or tensor) -> features
        [N, L // 320, hidden] float32 on the teacher's device."""
        if not torch.is_tensor(wave):
            wave = torch.from_numpy(np.ascontiguousarray(wave, np.float32))
        return wavlm_features(self.model, wave.to(self.device, torch.float32), segment_size)


def precompute_teacher_features(chunks: np.ndarray, checkpoint: str, out_path: Optional[str] = None,
                                batch_size: int = 8, device: DeviceLike = None) -> np.ndarray:
    """chunks [M, L] -> features [M, L // 320, hidden] (numpy float32), in
    batches of ``batch_size``; saved to ``out_path`` (``.npz``, key
    ``features``) when given."""
    teacher = WavLMTeacher(checkpoint, device)
    out = np.concatenate([teacher.extract(chunks[i:i + batch_size]).cpu().numpy()
                          for i in range(0, chunks.shape[0], batch_size)], axis=0)
    if out_path:
        np.savez(out_path, features=out)
    return out
