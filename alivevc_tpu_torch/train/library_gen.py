"""Voice-library generation from target-speaker audio
(``alivevc_tpu/train/library_gen.py``; reference:
generate_voice_library.py:21-43): for each of up to 512 chunks of 7 680
samples, the content frame at a random index in [0, 8) is written to a
random token slot in [0, num_tokens); later chunks overwrite earlier ones,
and slots no chunk hits keep their Gaussian init.  The slots and frames
come from numpy's ``default_rng(seed)`` in the JAX package's order, so they
equal its; the Gaussian init comes from a ``torch.Generator`` seeded with
``seed``.  The chunks are encoded in batches (the STFT kernel and the
content encoder on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from alivevc_tpu_torch.config import VoiceLibraryConfig
from alivevc_tpu_torch.device import DeviceLike, resolve_device
from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.ops.stft import spectrogram


def library_slots(m: int, n_frames: int, seed: int = 0, num_tokens: int = 512):
    """[(slot, frame)] for chunks 0..m-1, in the JAX package's draw order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        slot = int(rng.integers(0, num_tokens))
        out.append((slot, int(rng.integers(0, min(8, n_frames)))))
    return out


@torch.no_grad()
def generate_voice_library(ce: ContentEncoder, chunks: np.ndarray, seed: int = 0,
                           cfg: VoiceLibraryConfig = VoiceLibraryConfig(), batch_size: int = 64,
                           device: DeviceLike = None) -> VoiceLibrary:
    """chunks [M, 7680] target-speaker audio at 16 kHz -> a ``VoiceLibrary``
    on ``device``."""
    dev = resolve_device(device)
    vl = VoiceLibrary(cfg, generator=torch.Generator().manual_seed(seed)).to(dev)
    m = min(chunks.shape[0], cfg.num_tokens)
    feats = torch.cat([
        content_encoder(ce, spectrogram(torch.from_numpy(
            np.ascontiguousarray(chunks[i:i + batch_size], np.float32)).to(dev)))
        for i in range(0, m, batch_size)])                      # [M, T, D]
    for i, (slot, frame) in enumerate(library_slots(m, feats.shape[1], seed, cfg.num_tokens)):
        vl.tokens[0, :, slot] = feats[i, frame]
    return vl
