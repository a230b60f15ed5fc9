"""Content-encoder distillation from the WavLM teacher
(``alivevc_tpu/train/distill.py``; reference: train_content_encoder.py:62-87):
the L1 mean between the student's output on the wave's spectrogram and the
teacher's feature (``io/teacher.py``), ``optax.radam`` (``train/optim.py:
RAdam``).  On the card the spectrogram is the STFT kernel, forward only, one
launch a step: the wave is data and carries no gradient.

``dp_distill_step`` takes this rank's slice of the batch, its local
gradients and one flat all-reduce mean of the gradients and the loss
(``train/dp.py``): with equal slices the mean of the slices' L1 means is
the batch's, so the update equals the dense step's on the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.train import dp
from alivevc_tpu_torch.train.optim import RAdam, apply_grads


@dataclasses.dataclass
class DistillState:
    model: ContentEncoder
    opt: torch.optim.Optimizer
    step: int = 0


def init_distill(model: ContentEncoder, learning_rate: float = 1e-4) -> DistillState:
    model.train().requires_grad_(True)
    return DistillState(model, RAdam(model.parameters(), lr=learning_rate))


def distill_grads(state: DistillState, wave: torch.Tensor,
                  teacher_feature: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """wave [N, L] at 16 kHz, teacher_feature [N, L // 320, C]: (the gradient
    of each of the model's parameters, the loss), without updating."""
    out = content_encoder(state.model, spectrogram(wave))
    loss = torch.mean(torch.abs(out - teacher_feature))
    return list(torch.autograd.grad(loss, list(state.model.parameters()))), loss.detach()


def distill_step(state: DistillState, wave: torch.Tensor,
                 teacher_feature: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One update in place; returns {'loss': the pre-update loss}."""
    grads, loss = distill_grads(state, wave, teacher_feature)
    apply_grads(state.opt, list(state.model.parameters()), grads)
    state.step += 1
    return {"loss": loss}


def dp_distill_grads(state: DistillState, wave: torch.Tensor, teacher_feature: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """This rank's slice of the batch (equal slices on every rank): the
    gradients and the loss of the whole batch, by one flat all-reduce mean."""
    grads, loss = distill_grads(state, wave, teacher_feature)
    *grads, loss = dp.all_reduce_flat([*grads, loss], mean=True, group=group)
    return grads, loss


def dp_distill_step(state: DistillState, wave: torch.Tensor, teacher_feature: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """This rank's slice of the batch; the update equals the dense step's on
    the whole batch."""
    grads, loss = dp_distill_grads(state, wave, teacher_feature, group)
    apply_grads(state.opt, list(state.model.parameters()), grads)
    state.step += 1
    return {"loss": loss}
