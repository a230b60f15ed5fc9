"""F0-estimator training: per-frame 4096-way classification on WORLD labels
(``alivevc_tpu/train/f0.py``; reference: train_f0_estimator.py:62-88):
amplitude augmentation x U(0.25, 1) (``amp`` [N, 1], a tensor the caller
makes with ``f0_amp_draws``), cross entropy with ignore_index=0
(unvoiced), ``optax.radam`` (``train/optim.py:RAdam``).  On the card the
spectrogram is the STFT kernel.

``dp_f0_train_step`` all-reduces both parts of the cross entropy (the NLL
sum and the voiced count) before it divides, and sums the gradients of
sum / global count over the ranks: it equals the dense step on the whole
batch even when the ranks hold different voiced counts.  (The JAX
package's shard_map form psums the loss inside the differentiated function
and then psums the gradients again, which scales them by the number of
devices; the port does not follow it there.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from alivevc_tpu_torch.models.f0_estimator import F0Estimator, f0_estimator
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.train import dp
from alivevc_tpu_torch.train.losses import f0_cross_entropy_parts
from alivevc_tpu_torch.train.optim import RAdam, apply_grads


@dataclasses.dataclass
class F0TrainState:
    model: F0Estimator
    opt: torch.optim.Optimizer
    step: int = 0


def init_f0_train(model: F0Estimator, learning_rate: float = 1e-4) -> F0TrainState:
    model.train().requires_grad_(True)
    return F0TrainState(model, RAdam(model.parameters(), lr=learning_rate))


def f0_amp_draws(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """amp [n, 1] ~ U(0.25, 1) from a CPU generator, moved to ``device``."""
    return (torch.rand((n, 1), generator=generator) * 0.75 + 0.25).to(device)


def _loss_parts(state: F0TrainState, wave: torch.Tensor, f0: torch.Tensor, amp: torch.Tensor):
    logits = f0_estimator(state.model, spectrogram(wave * amp))
    return f0_cross_entropy_parts(logits, f0)


def f0_train_step(state: F0TrainState, wave: torch.Tensor, f0: torch.Tensor,
                  amp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """wave [N, L], f0 [N, L // 320] Hz labels, amp [N, 1]: one update in
    place; returns {'loss': the pre-update loss}."""
    total, count = _loss_parts(state, wave, f0, amp)
    loss = total / count.clamp(min=1)
    params = list(state.model.parameters())
    apply_grads(state.opt, params, torch.autograd.grad(loss, params))
    state.step += 1
    return {"loss": loss.detach()}


def dp_f0_train_step(state: F0TrainState, wave: torch.Tensor, f0: torch.Tensor, amp: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """This rank's slice of the batch; the update equals the dense step's on
    the whole batch."""
    total, count = _loss_parts(state, wave, f0, amp)
    sums = dp.all_reduce_flat([total.detach(), count.float()], mean=False, group=group)
    count_all = sums[1].clamp(min=1)
    params = list(state.model.parameters())
    grads = dp.all_reduce_flat(torch.autograd.grad(total / count_all, params), mean=False,
                               group=group)
    apply_grads(state.opt, params, grads)
    state.step += 1
    return {"loss": sums[0] / count_all}
