"""Training losses (``alivevc_tpu/train/losses.py``), matching the reference
loops:

  * mel L1 on log(mel + 1e-4) with NaN/Inf scrubbed (train_decoder.py:106-113, 141);
  * LSGAN with inverted labels: D trains real -> 0 and fake -> 1, G minimises
    logit^2 (train_decoder.py:143-161; SURVEY §2.4.3);
  * the discriminator losses see the centre quarter of the wave
    (cut_center_wav, train_decoder.py:80-84);
  * F0 cross entropy with ignore_index=0: unvoiced frames are left out
    (train_f0_estimator.py:59, 73-80).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.ops.stft import log_mel_spectrogram


def cut_center(x: torch.Tensor) -> torch.Tensor:
    """wave [N, L] -> its centre quarter [N, 2 * (L // 8)]."""
    length = x.shape[1]
    center, size = length // 2, length // 8
    return x[:, center - size:center + size]


def mel_l1_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (log_mel_spectrogram(fake) - log_mel_spectrogram(real)).abs().mean()


def generator_adv_loss(logits: List[torch.Tensor]) -> torch.Tensor:
    """G minimises the sum of mean(logit^2) over every sub-discriminator."""
    return sum((lg * lg).mean() for lg in logits)


def discriminator_adv_loss(logits_real: List[torch.Tensor],
                           logits_fake: List[torch.Tensor]) -> torch.Tensor:
    """D: real -> 0, fake -> 1 (inverted LSGAN labels)."""
    return (sum((lg * lg).mean() for lg in logits_real)
            + sum(((lg - 1.0) ** 2).mean() for lg in logits_fake))


def f0_cross_entropy_parts(logits: torch.Tensor, f0_hz: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the voiced frames' NLL, voiced count): the two parts of the
    ignore_index=0 mean, which the data-parallel F0 step all-reduces before
    it divides.  logits [N, T, C], f0_hz [N, T] or [N, T, 1]; label =
    floor(f0) clipped to [0, C - 1]."""
    if f0_hz.dim() == 3:
        f0_hz = f0_hz[..., 0]
    labels = torch.floor(f0_hz).long().clamp(0, logits.shape[-1] - 1)
    mask = labels != 0
    nll = -torch.gather(F.log_softmax(logits.float(), dim=-1), -1, labels[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros_like(nll)).sum(), mask.sum()


def f0_cross_entropy(logits: torch.Tensor, f0_hz: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the voiced frames; 0 when none is voiced (the max(1)
    guard, where torch's CrossEntropyLoss returns NaN)."""
    total, count = f0_cross_entropy_parts(logits, f0_hz)
    return total / count.clamp(min=1)
